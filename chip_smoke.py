#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (mobi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

  1. device   the card's name and power limit (nvidia-smi), TF32 settings
  2. build    nvcc builds mobi_tpu_torch/csrc/*.cu for sm_90a; when it
              built them in this run, each source's nvcc seconds and the
              registers, stack and spills that ptxas reports for each
              instantiation
  3. kernels  each CUDA kernel against its plain PyTorch version, with
              kernel, plain and library times and the least time the card
              could take (bound): K1 (flash forward) and K2 (flash forward
              with the transposed accumulator), in bf16 the wgmma/TMA
              kernel of csrc/flash_fwd_sm90.cu, and K6 (fused GroupNorm +
              SiLU) at the flagship's shapes and edge cases, in bf16 and
              (at the largest shapes) fp32, with the host's cost per call
              of the TMA kernel; K3 (flash forward with logsumexp; in bf16
              the same sm90 kernel with its lse output), K4 (dq) and K5
              (dk, dv; in bf16 the wgmma/TMA kernels of
              csrc/flash_bwd_sm90.cu, checked bitwise equal on a second run)
              at every shape of the training step and at edge cases, and in
              fp32 at the training shapes; every flash kernel at the head
              dims off the UNet's default two (64, 128, 160, 256, and 264,
              320 and 512 on csrc/flash_wide.cu, with
              SDPA's time, the bound's share and the spills of the
              instantiation that ran; K2 at 56); K6 with the launch plan of
              each shape, the first port's design timed beside it, and at
              spans off the main path (odd H * W, B * G not a multiple of
              the cluster size, 8 elements), in bf16 and fp32
  4. flagship the 512x512 joint camera + lidar DDIM-50 CFG-5 inpaint at the
              full width of MobiConfig() in bf16, seeded random weights,
              2 pairs: counts the kernel launches of one batch, times
              TIMED_BATCHES more with CUDA events, profiles a 2-step and a 4-step batch
              (device time by kernel class, scaled to 50 steps), and counts
              one batch with the fused GroupNorm + SiLU switch on
  5. switches one full-width UNet forward with the kernels against the same
              forward through the plain versions (fused GroupNorm + SiLU on
              and off; K1, K2 and the plain formula; attn_backend "flash",
              which sends the d = 160 calls of the 16x16 level and the
              middle block to K1 too)
  6. serve    the serving path (mobi_tpu_torch.serve_http.build_service,
              InpaintService) at the same full width, PLMS-50 CFG-5, 2 pairs
              a batch: 3 queued requests as batches [2, 1 + 1 padded]
              (counters, launches, walls, outputs equal to direct pipeline
              calls, one served batch's device time under torch.profiler),
              then 2 requests over HTTP from 2 threads;
              plms_tav: one of those batches again with the K2 switch on;
              test_bench: the served model through the evaluation entry
              point (mobi_tpu_torch/inference_test_bench.py, PLMS-50 CFG 5,
              4 objects a batch) on a synthetic database at 1600 x 900
              built by the port: 2 test batches and 1 rotation batch (the
              rotation batch under torch.profiler: its kernel seconds and
              the device's busy share), the files of every object and a
              finite metrics.csv checked, 1530 K1 launches a batch, device
              and host walls a batch, the loader's seconds a sample; batch
              0 again through the plain attention, and through the bench
              with the K2 and K6 switches on (launches counted; decoded
              camera and lidar within 3e-2 relative L2 of the plain run)
  eval     (after test_bench) the realism bench
              (mobi_tpu_torch/realism_test_bench.py main) with the served
              model on the test_bench database: seeded weights in the
              published layouts (HF CLIPModel ViT-B/32 with its text keys,
              torchvision inception_v3 with fc and AuxLogits, alexnet and
              the lpips heads, RangeNet++ darknet53), the four reference
              modes, PLMS-10 CFG 5, one batch of 4 objects a mode, the
              scorers in process, each network built once; FRD on each
              mode's range npys; format_results on the table. Gated: every
              table cell and FRD finite, the LaTeX row of 20 numbers and
              both averages, 11 x the UNet's flash calls of K1 a mode and
              none in the scorers, each network (CLIP B/32 + projection,
              Inception pool3, LPIPS, RangeNet at 64 x 1024) on the card
              within EVAL_REL_L2 relative L2 of the CPU in fp32 while the
              same network with TF32 on misses it, its parameters and
              outputs on the card; each network's items a second and peak
              memory at its CLI batch sizes
  7. fp32     the default MobiConfig() (fp32) at full width: one UNet
              forward through K1, K2 and K6 in fp32 against the plain
              versions, and the trainable gradients of one fp32 training
              loss at 1 pair through K3, K4 and K5 against the plain path
  camera_only  (after fp32) the camera-only Paint-by-Example model of
              configs/pbe_camera_256.yaml at full width (UNet 320 x
              (1, 2, 4, 4), VAE 128, CLIP ViT-L/14, one CLIP token, no lidar
              stage), bf16, seeded weights, bench.py's inputs at 256 x 256,
              its batch_size 4: one DDIM-50 CFG-5 batch counted (K1 at the
              32 x 32 level only, 5 calls a UNet forward), 2 timed with
              CUDA events, its device time by kernel class
              (camera_only_profile, as the flagship's profile), the same
              batch through the plain attention (decoded camera within
              UNET_REL_L2, no "lidar" key); the trainable gradients of one
              training loss at 2 pairs through K3-K5 against the plain
              attention within GRAD_REL_L2, with the whole UNet trainable
              (the camera-only UNet has no adapter)
  8. train    the adapter training step at the same full width (bf16
              compute, fp32 trainable masters, AdamW at lr 8e-5 with the
              200-step warm-up of configs/mobi_nusc_512.yaml), 2 pairs: one
              counted step, three timed with CUDA events, one with the fused
              GroupNorm + SiLU switch on, and the launches of one
              whole-UNet backward (MOBI_TRAIN_UNET_FULL=1)
  9. train_switches  the trainable gradients of one full-width training
              loss at 1 pair with the kernels against the plain versions
              (MOBI_FLASH_BWD kernels and xla; fused norm on and off;
              attn_backend "flash", K3-K5 at d = 160 included)
  10. oracle  the learning path (mobi_tpu_torch/overfit_oracle.py): the
              tiny-config learning gate of tests/test_overfit_oracle.py on
              the card (a child process of this file, --oracle-tiny, run
              beside scale_out: its steps are host-bound and scale_out's
              parent only waits), its steps, seeds and thresholds, with
              attn_backend "flash" (K3-K5 in every training step, K1 in
              every sampling step); gated: the VAE and loss thresholds,
              the kernels against the plain versions at the trained
              weights (gradient and DDIM-10 latents), and over 12 draws
              the camera mean beating the baseline and the untrained
              model, the lidar mean the untrained model; the sampled
              thresholds reported for each draw; then the whole-UNet
              overfit at mini-256 full width (bf16, AdamW with a bf16
              first moment and the zero-init knob, ORACLE_DIFF_STEPS
              steps of the 200-step warm-up): window-mean loss descent,
              median step wall, device busy share, peak memory, K3-K5
              launches per step against the config's flash calls,
              SegmentedInpaint.preflight, and DDIM-20 and segmented
              PLMS-20 at guidance 5 (finite, counted, masked PSNRs
              printed, not gated at this step count)
  remat    (after train_switches) one full-width training loss and its
              backward, 2 pairs, injected t, noise and drop, with the UNet's
              use_checkpoint False, "transformer" and True: peak memory,
              device time, K3-K5 launches, the remat'd trainable gradients
              within 1e-3 relative L2 of the run without
  11. train_cli  the training CLI (mobi_tpu_torch/train.py main) at the
              full width of configs/mobi_nusc_512.yaml (bf16, batch_size 2),
              seeded weights with MOBI_RANDOMIZE_ZERO_INIT, use_ema, the
              reference's scheduler class, a synthetic database at
              1600 x 900: 16 steps (validation, a save and collages at 8
              and 16, a profiler trace of steps 10-15), then --resume to 18;
              gated on finite losses, every logged step, the collages, the
              retained checkpoints, a bitwise restore and
              convert.load_checkpoint of the directory
  range_vae  (after train_cli) the range-VAE finetune
              (mobi_tpu_torch/train_autoencoder.py main) at the full width of
              configs/range_autoencoder.yaml (512 x 512 range views, batch 4,
              fp32, remat, the lidar adapter), seeded weights, a synthetic
              database: 2 steps with the GAN terms gated off, 3 with
              disc_start 0; gated on finite logs, the GAN weight, the
              discriminator still while gated and moved after, the frozen
              VAE bitwise and the adapter moved; step walls, peak memory and
              the busy share of a profiled step; extract_autoencoder of its
              last checkpoint loaded strict, bitwise; export_checkpoint of
              train_cli's final checkpoint (with EMA) reloaded strict,
              bitwise, its bytes and seconds
  detection  (in a child of this file, --detection, beside scale_out, with
              det_train after it; its lines printed again after scale_out)
              checkpoint-driven BEVFusion detection at
              the production grid (voxels 0.075 x 0.075 x 0.2 m, sparse
              shape 1440 x 1440 x 41, BEV 180 x 180, 200 proposals, 10
              classes): a 2-scene x 3-sample raw nuScenes tree from
              build_synthetic_nuscenes_raw, the preprocess CLI over it
              (mobi_tpu_torch.data.preprocess main, --write-infos), then
              for the lidar-only and the camera + lidar detector a
              full-size checkpoint with the JAX drive's draws (N(0, 0.05),
              BN variances |v| + 0.5) written by
              convert.save_reference_checkpoint, loaded strict, and
              mobi_tpu_torch.detection_eval main with --checkpoint,
              --sweeps-num 2 and --max-samples 6 (camera: 3, 6 views at
              256 x 704): results.json and metrics_summary.json gated,
              host and card seconds a sample, peak memory, K1-K6 launches
              (none lie on this path); then one sample of each model on
              the card against the CPU with unit-gain seeded weights,
              every pre-decode output within DET_REL_L2 with TF32 off
              and a TF32-on control that must miss it, and for the lidar
              model where its reading comes from (each side against a CPU
              fp64 forward, the cross attention alone, cuDNN off); real density
              (after scale_out): a fabricated cloud of DET_DENSE_VOXELS
              non-empty voxels, voxelized and planned on the host by a
              child of this file (--detection-plan) beside scale_out, then
              each model's median card ms of DET_DENSE_FORWARDS forwards
              after a warm-up, and its peak memory, with TF32 off and under
              PyTorch's default (cuDNN convolutions in TF32); the camera
              model's also with its LSS cells made inside the forward
              after a wait for the card
  det_train  (in the detection child, after detection) detector training at the
              production grid: one step of the lidar detector (TransFusion loss,
              the host Hungarian, AdamW on every parameter, BatchNorm's
              statistics included) on the detection phase's comparison sample
              with its unit-gain weights, card against CPU with TF32 off: the
              matching equal, the loss within DET_TRAIN_LOSS_RTOL, the gradients
              within DET_TRAIN_GRAD_REL_L2 relative L2, a TF32-on control that
              must miss; DET_TRAIN_TIMED_STEPS more steps on the card (CUDA
              events), their peak memory and a profiled step's busy share (phase
              det_train_step); then the training CLI (mobi_tpu_torch.
              train_detector main) on the detection phase's raw tree with a GT
              database built by the port: lidar 10 steps with GT paste and
              checkpoints at 5 and 10, camera + lidar 2 steps at --batch-size 2
              with --image-aug and --grid-mask 0.5 (6 views at 256 x 704); gated
              on finite losses, num_pos > 0, the metrics.jsonl line, the
              checkpoints, the lidar checkpoint through detection_eval's
              inference on one sample to finite boxes, and no K1-K6 launch; host
              seconds a sample (pipeline, planning), card ms a step and peak
              memory printed
  centerpoint  (in the detection child, after det_train_step) the CenterPoint
              head (mobi_tpu_torch/models/centerpoint.py) at the production
              widths (512 channels, BEV 180 x 180, 10 classes, 500
              detections): forward, decode, loss and backward, card against
              CPU in fp32 with TF32 off (maps within DET_REL_L2, loss within
              DET_TRAIN_LOSS_RTOL, gradients within DET_TRAIN_GRAD_REL_L2,
              decode's labels and indices equal on the same maps), a TF32-on
              control that must miss, ms a step; point_ops: the four point
              ops (mobi_tpu_torch/ops/point_ops.py) at a PAConv-sized shape,
              card against CPU (gathers bitwise, contractions within
              POINT_OPS_REL_L2); neither launches K1-K6
  lifecycle  (a child beside scale_out, its line printed after it) python -m
              mobi_tpu_torch.lifecycle_drive, each phase in a process of its
              own: a 2-scene x 3-sample raw tree, preprocess, the inference
              test bench on configs/mobi_nusc_512.yaml with train_cli's final
              full-width checkpoint (DDIM-50, scale 5, 4 objects a batch, 2
              batches), a lidar detector checkpoint with the JAX drive's
              draws, the detection eval over the edited samples restricted
              to the edited objects; gated on every phase's exit code, the
              inpaint's K1 launches (batches x 50 x 30) and none elsewhere,
              edited lidar and camera files read by the eval's dataset, and
              finite metrics; each phase's wall time printed
  legacy     (a child of this file, --legacy, beside scale_out; its lines
              printed again after it) the legacy surfaces at full width:
              EncoderUNetModel at its JAX defaults (320 x (1, 2, 4, 4), 2
              res blocks, attention at ds 4, 2, 1, 8 heads, 1000 classes)
              with the attention pool on a seeded [4, 4, 64, 64] latent, fp32
              and bf16 forwards against the plain attention
              (FP32_UNET_REL_L2, UNET_REL_L2) with K1 4 a forward, and built
              under MOBI_FUSED_GN=1 against the unfused norm with K6 20;
              a NoisyLatentClassifier (10 classes, that width) loss at batch
              4 with t and noise injected, its gradients against the plain
              backward within FP32_GRAD_REL_L2 with K3, K4 and K5 4 each,
              then LEGACY_TIMED_STEPS Adam steps, walls and peak memory; the
              lidar VQModel at its class defaults on [4, 1, 32, 1024] range
              images, card against CPU (TF32 off): the latent and the decode
              within LEGACY_REL_L2 with a TF32-on control that must miss,
              the code indices equal off near ties (their share printed);
              CLIPTextTower at ViT-L/14's text width and BERTEmbedder at its
              defaults with a padding mask, card against CPU likewise (no
              kernel lies on the VQ and text paths); then K1 (bf16, fp32),
              K3-K5 (fp32) and K6 (fp32) at these shapes against their plain
              versions with times and bounds
  12. scale_out  the port's torch.distributed path (mobi_tpu_torch/parallel):
              nccl1, the full-width adapter step on a one-rank NCCL mesh
              against the bare step (2 pairs, injected draws, 2 steps);
              dp2 and fsdp2, the training CLI as two ranks sharing the card
              over gloo (batch_size 1 a rank, --fsdp 2 for the second) against
              one process at batch_size 2 on the same seed and data (a 1-step
              lr warm-up), with a validation of 2 batches, an image log (dp2)
              and a save at the last step (SCALE_OUT_STEPS for dp2,
              FSDP2_STEPS for fsdp2): the losses and the trainable weights'
              updates of rank 0's checkpoint against the one process's, the
              checkpoint read by convert.load_checkpoint, and fsdp2's
              resident memory against dp2's and its peak (per-block
              gathering) against dp2's peak less 0.7 x the saving at rest; mesh_dp2, inference_test_bench --mesh-dp 2 as two ranks
              on the test_bench database (one batch of 4 objects, PLMS-50
              CFG 5) against the one-process bench's batch 0; each rank's
              K1 and K3-K5 launches, walls and peak memory. The ranks run
              this file with --scale-out-rank, after the parent built the
              kernels
  13. the {"kernels": [...]} line (K1-K6, with each path's launches: the
     camera-only model's, CenterPoint's, the point ops', each lifecycle
     phase's and each legacy path's (`legacy_launches`) among them, and
     under `legacy` each kernel's times at the legacy shapes), then the
     card's name and power limit, and last
     {"ok": true, "device": {...}}.

It needs a CUDA device and the mobi_tpu_torch package beside it; without
either it exits 2 and prints no result. It imports nothing of JAX.

`python3 chip_smoke.py --scale-out-control` runs, after the build, only the
control of the dp2 update gate: the one process and dp2 with each rank
stepping on its own gradient (the mean over ranks skipped), its losses and
update reading printed and not gated.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PAIRS = 2
STEPS = 50
GUIDANCE = 5.0
TIMED_BATCHES = 2       # few: the script's time limit
PROFILE_STEPS = (2, 4)
SEED = 0
TRAIN_PAIRS = 2         # batch_size of configs/mobi_nusc_512.yaml
TRAIN_TIMED_STEPS = 3   # likewise
TRAIN_LR, TRAIN_WARMUP = 8e-5, 200   # base_learning_rate, warm_up_steps
SWITCH_PAIRS = 1
SERVE_PAIRS = 2         # the service's batch_pairs
SERVE_REQUESTS = 3      # queued before the dispatcher starts: batches [2, 1 + 1 padded]
PLMS_EVALS = STEPS + 1  # PLMS-50 evaluates the UNet twice at step 0
# The oracle phase. (a) The learning gate of tests/test_overfit_oracle.py on
# the card: its tiny config (tests/test_diffusion.py TINY, u_cond_percent 0)
# with attn_backend "flash", its steps (VAE 400, diffusion 800, DDIM-10
# sampling) and its thresholds (:89-135). Gated: VAE recon L1 below 0.05,
# final diffusion loss below 0.15, the kernels against the plain versions at
# the trained weights, and over 12 noise draws the trained camera mean above
# the do-nothing baseline and the untrained mean, the lidar mean above the
# untrained mean. Reported on every draw and on the JAX test's own (seed 7):
# camera PSNR 2.5 dB over the baseline and above 13.5 dB, lidar 1.0 dB over
# it and above 11.5 dB, camera 4 dB and lidar 2 dB over the untrained model,
# lidar depth MSE below 0.3; the JAX package meets these on few draws of its
# own weights (tests/test_torch_oracle_witness.py, PERF.md §6). (b) The whole-UNet
# overfit at the full width of configs/mobi_nusc-mini_256.yaml, bf16
# compute, seeded weights, 4 objects: a short VAE run, ORACLE_DIFF_STEPS of
# AdamW with a bf16 first moment and the zero-init knob on the trainer's
# default schedule (a 200-step linear warm-up: the drive's warm-up cosine
# squeezed into a few hundred steps reaches its peak lr by step 60 and fell
# back to a loss of ~1.0 on the card, PERF.md §7), then DDIM-20 and
# segmented PLMS-20 (2 segments) at guidance 5.
ORACLE_TINY_STEPS = {"vae": 400, "diffusion": 800, "sample": 10}
ORACLE_TINY_GATE = {"vae_l1_max": 0.05, "final_loss_max": 0.15, "camera_margin_db": 2.5, "camera_min_db": 13.5,
                    "lidar_margin_db": 1.0, "lidar_min_db": 11.5, "camera_over_untrained_db": 4.0,
                    "lidar_over_untrained_db": 2.0, "depth_mse_max": 0.3}
ORACLE_TINY_DRAWS = 12  # sampling draws (seeds 0-11) beside the JAX test's own (seed 7)
ORACLE_TINY_TIMEOUT_S = 300  # the child's wait after scale_out (it takes 138-181 s alone)
ORACLE_OBJECTS, ORACLE_VAE_STEPS, ORACLE_DIFF_STEPS = 4, 20, 60
ORACLE_SAMPLE_STEPS, ORACLE_GUIDANCE, ORACLE_PLMS_SEGMENTS = 20, 5.0, 2
ORACLE_WINDOW = 20  # steps in each loss window mean: the first window against the last

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit) and the
# special-function (exp2) rate cited by FlashAttention-3. The fp32 flash
# kernels run each product as three tf32 products on the tensor cores
# (3xTF32), so their bound counts 3x the flops at the TF32 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_SFU_OPS = 3.9e12
PEAK_BYTES = 3.35e12
# cuda_ms's spin kernel: cycles per second at the H100's 1.98 GHz boost clock
# (at a lower clock the spin only lasts longer)
SPIN_CYCLES_PER_S = 1.98e9

# Kernel vs plain version, both in bf16: |kernel - plain| <= ATOL + RTOL*|plain|.
# K1: both round their output to bf16, so RTOL is two bf16 ulps relative. The
# absolute term scales with the output: attention averages V, so with unit
# V the outputs have a std of about sqrt(e / N), 0.026 at N = 4096. Rounding
# the weights P to bf16 (2^-9 relative, the kernel before the sum, the plain
# version after it) moves an output by about 2^-9 x that std, so the tails
# over 10^7 outputs should stay near 0.01 std; ATOL is 2^-5 = 0.031 std of
# the plain output. Dropping one 64-key tile of 4096 moves an output by
# about 0.08 std. Each row prints its max error over the tolerance.
K1_ATOL_STD, K1_RTOL = 2 ** -5, 2 ** -6
# K6: outputs silu(GN(x) * gamma + beta) are of unit scale; the kernel takes the
# variance as E[x^2] - mean^2 and the plain version two-pass, both fp32, so
# the bf16 output rounding dominates.
K6_ATOL, K6_RTOL = 1e-2, 2 ** -6
# fp32 kernels against the fp32 plain versions (TF32 off). K1 and K2: atol
# 2e-5, the JAX kernel's own fp32 tolerance (tests/test_flash_attention.py:27);
# their 3xTF32 products keep ~22 bits of each operand. Each main-path row
# also runs the plain version with TF32 on (11 bits) as a control, which
# must fail that tolerance, so the check tells fp32 from TF32. K6: the two
# variance formulas and __expf differ by a few 1e-6 at unit-scale outputs.
F32_ATOL = 2e-5
K6_F32_ATOL, K6_F32_RTOL = 2e-5, 1e-5
# Whole-UNet eps with kernels vs plain versions, relative L2 error: bf16
# rounding differences compound over ~100 layers.
UNET_REL_L2 = 3e-2
# The same in fp32: the kernels differ from the plain versions by ~1e-6
# relative per call (3xTF32 products, ex2.approx, another summation order),
# compounded over the same depth; 1e-4 leaves that two decades.
FP32_UNET_REL_L2 = 1e-4
# K3's lse is fp32: the kernel's and the plain version's sums of N
# exponentials differ in order and by ex2.approx's 2^-22 relative error, a
# few 1e-6 of lse; dropping one 64-key tile of 4096 moves it by 0.016.
LSE_ATOL, LSE_RTOL = 1e-3, 1e-5
# K4 and K5 (dq, dk, dv) take K1's tolerance, 2^-5 of the plain output's std
# plus two bf16 ulps relative: the largest difference is dS, which both round
# to bf16 from fp32 values summed in another order, so some elements round
# the other way (2^-9 relative) and a gradient sums many with both signs.
# Where dP - delta cancels (nearly one-hot rows of extreme logits) the exact
# gradient is ~0 and fp32 rounding of dP - delta, carried through K or Q, is
# left: ~1e-7 at unit-scale inputs, ~2e-5 at q = 8, k ~ 8 N(0, 1). The floor
# BWD_ATOL_MIN times the inputs' scale (rms of q and k, at least 1) covers it.
BWD_ATOL_STD, BWD_ATOL_MIN, BWD_RTOL = 2 ** -5, 1e-5, 2 ** -6
# The bf16 K4 and K5 that the wgmma kernels of csrc/flash_bwd_sm90.cu
# replaced (mma.sync, csrc/flash_bwd.cu), ms per call at the training step's
# shapes (B, N, H, D), as this script's kernel phase timed them on an H100
# 80GB HBM3 at 700 W (PERF.md): each main-path row prints them as "was_ms".
MMA_SYNC_BWD_MS = {
    "flash_bwd_dq": {(4, 4096, 8, 40): 0.6922, (2, 4096, 8, 40): 0.3494,
                     (4, 1024, 8, 80): 0.0775, (2, 1024, 8, 80): 0.0402},
    "flash_bwd_dkv": {(4, 4096, 8, 40): 0.9493, (2, 4096, 8, 40): 0.4897,
                      (4, 1024, 8, 80): 0.0976, (2, 1024, 8, 80): 0.0504},
}
# The bf16 K3 that the sm90 kernel's lse output replaced (mma.sync,
# csrc/flash_fwd.cu, removed since), ms per training step at UNet batch 4,
# as this script's kernel phase timed it on an H100 80GB HBM3 at 700 W
# (PERF.md): the train_kernels_per_step line prints it under
# "was_ms_not_measured_here", and the kernels line leaves it out.
MMA_SYNC_K3_MS_PER_STEP = 4.657
# Kernel rows off the UNet's default head dims, (B, N, H, D): each flash
# kernel at the 64 and 128 builds, at d = 160 (the 16x16 and 8x8 levels'
# calls under attn_backend: flash, two slices of 80), at 256 (four slices
# of 64) and above 256 on csrc/flash_wide.cu (264: a chunk and a slice
# mostly past d; 320 and 512 fill theirs), with times, bound and SDPA; K2,
# which serves d < 64, at 56. K6 at
# spans off the main path: an H * W that is not a multiple of 8 (the
# streaming variant), B * G not a multiple of the cluster size, a span of 8
# elements.
HEAD_DIM_SHAPES = ((4, 1024, 8, 64), (4, 1024, 4, 128), (8, 256, 8, 160), (8, 64, 8, 160), (4, 1024, 4, 256),
                   (2, 1024, 2, 264), (2, 1024, 2, 320), (2, 1024, 2, 512))
TAV_HEAD_DIM_SHAPES = ((4, 1024, 8, 56),)
GN_SPAN_SHAPES = ((2, 64, 7, 9), (3, 31, 240, 240), (2, 64, 2, 2))
TIMED_CASES = ("main_path", "head_dim")  # kernel rows with times and bound
# Trainable gradients of one training loss, kernels vs plain versions,
# relative L2: the gradient passes the depth twice (the forward, then the
# backward), so twice the forward's UNET_REL_L2; in fp32 twice FP32_UNET_REL_L2.
GRAD_REL_L2 = 2 * UNET_REL_L2
FP32_GRAD_REL_L2 = 2 * FP32_UNET_REL_L2
# fp32 K3-K5 against their fp32 plain versions (TF32 off), as
# tests/test_torch_kernels.py holds them: o, dq, dk and dv within 2^-10 of
# the reference's std (plus 1e-6 times the inputs' scale, the floor where
# dP - delta cancels), the lse within 2e-5 absolute. 3xTF32 with ex2.approx
# leaves about 1e-4 to 6e-4 of the std (the tensor cores' fp32 accumulation
# over N keys); the plain version with TF32 on misses by about 1e-2 of the
# std, and each main-path row asserts that this control fails the tolerance.
F32_ATOL_STD, F32_ATOL_MIN, LSE_F32_ATOL = 2 ** -10, 1e-6, 2e-5

# configs/mobi_nusc_512.yaml as utils.config.load_config returns it, for the
# test_bench phase where PyYAML is not installed (tests/test_torch_test_bench.py
# holds the two equal)
BENCH_CONFIG = {'use_camera': True,
                'use_lidar': True,
                'image_height': 512,
                'image_width': 512,
                'latent_size': 64,
                'range_height': 512,
                'range_width': 512,
                'batch_size': 2,
                'range_object_norm': True,
                'range_object_norm_scale': 0.75,
                'range_int_norm': True,
                'num_workers_per_gpu': 8,
                'precision': 'bf16',
                'ref_mode': 'track-ref',
                'object_area_crop': 0.2,
                'classes': ['car', 'pedestrian'],
                'conditions': ['ref_image', 'ref_bbox'],
                'model': {'base_learning_rate': 8e-05,
                          'target': 'mobi_tpu.models.diffusion.MobiDiffusion',
                          'params': {'linear_start': 0.00085,
                                     'linear_end': 0.012,
                                     'timesteps': 1000,
                                     'first_stage_key': 'inpaint',
                                     'cond_stage_key': ['ref_image', 'ref_bbox'],
                                     'image_size': 64,
                                     'channels': 4,
                                     'cond_stage_trainable': True,
                                     'conditioning_key': 'crossattn',
                                     'monitor': 'val/loss_simple',
                                     'u_cond_percent': 0.2,
                                     'scale_factor': 0.18215,
                                     'lidar_scale_factor': 0.18215,
                                     'use_ema': False,
                                     'use_camera': True,
                                     'use_lidar': True,
                                     'range_object_norm': True,
                                     'range_object_norm_scale': 0.75,
                                     'range_int_norm': True,
                                     'scheduler_config': {'target': 'mobi_tpu.training.lambda_linear_schedule',
                                                          'params': {'warm_up_steps': [200],
                                                                     'cycle_lengths': [10000000000000],
                                                                     'f_start': [1e-06],
                                                                     'f_max': [1.0],
                                                                     'f_min': [1.0]}},
                                     'unet_config': {'target': 'mobi_tpu.models.unet.UNetModel',
                                                     'params': {'image_size': 64,
                                                                'in_channels': 9,
                                                                'out_channels': 4,
                                                                'model_channels': 320,
                                                                'attention_resolutions': [4, 2, 1],
                                                                'num_res_blocks': 2,
                                                                'channel_mult': [1, 2, 4, 4],
                                                                'num_heads': 8,
                                                                'transformer_depth': 1,
                                                                'context_dim': 768,
                                                                'use_checkpoint': False,
                                                                'bbox_cond': True,
                                                                'use_camera': True,
                                                                'use_lidar': True}},
                                     'first_stage_config': {'target': 'mobi_tpu.models.vae.AutoencoderKL',
                                                            'params': {'embed_dim': 4,
                                                                       'ddconfig': {'double_z': True,
                                                                                    'z_channels': 4,
                                                                                    'resolution': 512,
                                                                                    'in_channels': 3,
                                                                                    'out_ch': 3,
                                                                                    'ch': 128,
                                                                                    'ch_mult': [1, 2, 4, 4],
                                                                                    'num_res_blocks': 2,
                                                                                    'attn_resolutions': [],
                                                                                    'dropout': 0.0}}},
                                     'lidar_stage_config': {'target': 'mobi_tpu.models.vae.AutoencoderKL',
                                                            'params': {'embed_dim': 4,
                                                                       'ckpt_path': 'checkpoints/mobi_nusc_512/autoencoders/range_autoencoder.ckpt',
                                                                       'ddconfig': {'double_z': True,
                                                                                    'z_channels': 4,
                                                                                    'resolution': 512,
                                                                                    'in_channels': 2,
                                                                                    'out_ch': 2,
                                                                                    'ch': 128,
                                                                                    'ch_mult': [1, 2, 4, 4],
                                                                                    'num_res_blocks': 2,
                                                                                    'attn_resolutions': [],
                                                                                    'lidar_adapter': True,
                                                                                    'dropout': 0.0}}},
                                     'cond_stage_config': {'target': 'mobi_tpu.models.encoders.CondStageModel',
                                                           'params': {'conditions': ['ref_image', 'ref_bbox']}}}},
                'data': {'params': {'batch_size': 2,
                                    'num_workers_per_gpu': 8,
                                    'train': {'target': 'mobi_tpu.data.nuscenes.NuScenesDataset',
                                              'params': {'state': 'train',
                                                         'use_lidar': True,
                                                         'use_camera': True,
                                                         'object_database_path': 'processed-data/nuscenes/nuscenes_dbinfos_pbe_train.csv',
                                                         'scene_database_path': 'processed-data/nuscenes/nuscenes_scene_infos_pbe_train.pkl',
                                                         'expand_mask_ratio': 0.1,
                                                         'expand_ref_ratio': 0,
                                                         'object_area_crop': 0.2,
                                                         'num_samples_per_class': 4096,
                                                         'fixed_sampling': False,
                                                         'ref_aug': True,
                                                         'ref_mode': 'track-ref',
                                                         'prob_erase_box': 0.3,
                                                         'image_height': 512,
                                                         'image_width': 512,
                                                         'range_height': 512,
                                                         'range_width': 512,
                                                         'object_classes': ['car', 'pedestrian'],
                                                         'random_range_crop': False,
                                                         'range_object_norm': True,
                                                         'range_object_norm_scale': 0.75,
                                                         'range_int_norm': True}},
                                    'validation': {'target': 'mobi_tpu.data.nuscenes.NuScenesDataset',
                                                   'params': {'state': 'val',
                                                              'use_lidar': True,
                                                              'use_camera': True,
                                                              'object_database_path': 'processed-data/nuscenes/nuscenes_dbinfos_pbe_val.csv',
                                                              'scene_database_path': 'processed-data/nuscenes/nuscenes_scene_infos_pbe_val.pkl',
                                                              'expand_mask_ratio': 0.1,
                                                              'expand_ref_ratio': 0,
                                                              'object_area_crop': 0.2,
                                                              'num_samples_per_class': 512,
                                                              'fixed_sampling': True,
                                                              'prob_erase_box': 0.3,
                                                              'ref_aug': True,
                                                              'ref_mode': 'track-ref',
                                                              'image_height': 512,
                                                              'image_width': 512,
                                                              'range_height': 512,
                                                              'range_width': 512,
                                                              'object_classes': ['car', 'pedestrian'],
                                                              'random_range_crop': False,
                                                              'range_object_norm': True,
                                                              'range_object_norm_scale': 0.75,
                                                              'range_int_norm': True}},
                                    'test': {'target': 'mobi_tpu.data.nuscenes.NuScenesDataset',
                                             'params': {'state': 'test',
                                                        'use_lidar': True,
                                                        'use_camera': True,
                                                        'object_database_path': 'processed-data/nuscenes/nuscenes_dbinfos_pbe_val.csv',
                                                        'scene_database_path': 'processed-data/nuscenes/nuscenes_scene_infos_pbe_val.pkl',
                                                        'expand_mask_ratio': 0.1,
                                                        'expand_ref_ratio': 0,
                                                        'object_area_crop': 0.2,
                                                        'num_samples_per_class': 64,
                                                        'fixed_sampling': True,
                                                        'object_random_crop': False,
                                                        'ref_aug': False,
                                                        'ref_mode': 'track-ref',
                                                        'image_height': 512,
                                                        'image_width': 512,
                                                        'range_height': 512,
                                                        'range_width': 512,
                                                        'object_classes': ['car', 'pedestrian'],
                                                        'range_object_norm': True,
                                                        'range_object_norm_scale': 0.75,
                                                        'range_int_norm': True}},
                                    'rotation_test': {'target': 'mobi_tpu.data.nuscenes.NuScenesDataset',
                                                      'params': {'state': 'test',
                                                                 'use_lidar': True,
                                                                 'use_camera': True,
                                                                 'object_database_path': 'processed-data/nuscenes/nuscenes_dbinfos_pbe_val.csv',
                                                                 'scene_database_path': 'processed-data/nuscenes/nuscenes_scene_infos_pbe_val.pkl',
                                                                 'expand_mask_ratio': 0.1,
                                                                 'expand_ref_ratio': 0,
                                                                 'object_area_crop': 0.2,
                                                                 'num_samples_per_class': 8,
                                                                 'fixed_sampling': True,
                                                                 'ref_aug': False,
                                                                 'object_random_crop': False,
                                                                 'ref_mode': 'id-ref',
                                                                 'image_height': 512,
                                                                 'image_width': 512,
                                                                 'range_height': 512,
                                                                 'range_width': 512,
                                                                 'rot_every_angle': 30,
                                                                 'range_object_norm': True,
                                                                 'range_object_norm_scale': 0.75,
                                                                 'range_int_norm': True,
                                                                 'object_classes': ['pedestrian', 'car']}}}},
                'trainer': {'max_epochs': 30}}


_T0 = time.perf_counter()
_EMITTED = []  # a child's phase lines, which its parent prints again


def emit(obj) -> None:
    """One JSON line; a phase line also gets the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
        _EMITTED.append(obj)
    print(json.dumps(obj), flush=True)


def kernel_name(mangled: str) -> str:
    """name<template args> of a mangled kernel: the first identifier that
    ends in "kernel", is preceded by its length and followed by template
    arguments."""
    import re

    for m in re.finditer(r"(?=((?:flash|gn)_\w*?kernel)I(\w+?)EE)", mangled):
        if mangled[:m.start()].endswith(str(len(m[1]))):
            args = re.findall(r"L[a-z](\d+)", m[2])
            # a type argument first (flash_wide.cu): bf16 or fp32
            args = (["bf16"] if "bfloat16" in m[2] else ["fp32"] if m[2].startswith("f") else []) + args
            return f"{m[1]}<{', '.join(args) or m[2]}>"
    return mangled


def ptxas_report(log: Path):
    """Registers, stack and spill bytes that ptxas -v reported for each
    kernel instantiation of every source, from the build's log, with the
    notes that name the instantiation (setmaxnreg, "Potential Performance
    Loss")."""
    import re

    rows, source = [], None
    for line in log.read_text().splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif source:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                rows.append({"source": source, "kernel": kernel_name(m.group(1)), "mangled": m.group(1)})
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and rows:
                rows[-1].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m and rows:
                rows[-1]["registers"] = int(m[1])
    notes = [line.strip() for line in log.read_text().splitlines()
             if "setmaxnreg" in line or "Performance" in line]
    for row in rows:
        row["notes"] = [n.split(")", 1)[-1].split(" for the function")[0].strip()
                        for n in notes if row["mangled"] in n]
        if not row["notes"]:
            del row["notes"]
        del row["mangled"]
    return rows


# The instantiations of each flash kernel, by (name, dtype): the kernel's
# name in the ptxas report and, for a kernel built with and without a flag,
# the flag's value (K2 in the sm90 forward; K3 in the fp32 forward).
_INSTANTIATIONS = {
    ("flash_fwd", "bfloat16"): ("flash_fwd_sm90_kernel", "0"),
    ("flash_fwd_lse", "bfloat16"): ("flash_fwd_sm90_kernel", "0"),
    ("flash_fwd_tav", "bfloat16"): ("flash_fwd_sm90_kernel", "1"),
    ("flash_fwd", "float32"): ("flash_fwd_kernel", "0"),
    ("flash_fwd_lse", "float32"): ("flash_fwd_kernel", "1"),
    ("flash_fwd_tav", "float32"): ("flash_fwd_tav_kernel", None),
    ("flash_bwd_dq", "bfloat16"): ("flash_bwd_dq_sm90_kernel", None),
    ("flash_bwd_dq", "float32"): ("flash_bwd_dq_kernel", None),
    ("flash_bwd_dkv", "bfloat16"): ("flash_bwd_dkv_sm90_kernel", None),
    ("flash_bwd_dkv", "float32"): ("flash_bwd_dkv_kernel", None),
}


def ptxas_for(report, name: str, dtype: str, d: int):
    """The instantiation that ran flash kernel `name` at head dim d, with its
    registers and spill bytes (stores + loads) from the build's ptxas report:
    the narrowest built width that holds d. Empty without a report."""
    base, flag = _INSTANTIATIONS[(name, dtype)]

    def width(row):
        return int(row["kernel"][len(base) + 1:].split(",")[0].rstrip(">"))

    built = [r for r in report if r["kernel"].startswith(base + "<")
             and (flag is None or r["kernel"].endswith(f", {flag}>")) and width(r) >= -(-d // 8) * 8]
    if not built:
        return {}
    row = min(built, key=width)
    return {"instantiation": row["kernel"], "registers": row.get("registers"),
            "spill_bytes": row.get("spill_stores", 0) + row.get("spill_loads", 0)}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over `iters` launches, CUDA events.
    The launches are queued behind a spin kernel, so the card runs them back
    to back and a kernel shorter than its wrapper's host cost (40-50 us a
    call) is timed, not the host's launch rate. Where the host took longer
    to queue them than the spin lasted, the run is repeated behind a spin of
    twice that."""
    import torch

    for _ in range(warmup):
        fn()
    spin_s = 0.02
    for _ in range(3):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if host_s < spin_s:
            break
        spin_s = 2 * host_s
    return start.elapsed_time(end) / iters


def bound(flops: float, sfu: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops = max(flops / peak_flops, sfu / PEAK_SFU_OPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def unet_flash_calls(cfg, unet_batch: int, backend: str = "auto"):
    """(B, N, H, D) of every flash call of one UNet forward, in order: each
    transformer's self-attention and its two cross-modal attentions (the
    camera-only UNet has none), at the levels the "auto" rule takes
    (N >= 1024), or at every level with the backend "flash"
    (MobiConfig.attn_backend)."""
    calls, size, ds = [], cfg.latent_size, 1
    res = list(cfg.unet_attention_resolutions)
    mc, heads = cfg.unet_channels, cfg.unet_num_heads
    levels = []  # (ds, channels) of each transformer
    for level, mult in enumerate(cfg.unet_channel_mult):
        levels += [(ds, mult * mc)] * (cfg.unet_num_res_blocks if ds in res else 0)
        if level != len(cfg.unet_channel_mult) - 1:
            ds *= 2
    levels.append((ds, cfg.unet_channel_mult[-1] * mc))
    for level, mult in reversed(list(enumerate(cfg.unet_channel_mult))):
        levels += [(ds, mult * mc)] * ((cfg.unet_num_res_blocks + 1) if ds in res else 0)
        if level:
            ds //= 2
    for ds, ch in levels:
        n = (size // ds) ** 2
        if backend == "flash" or n >= 1024:  # the "auto" rule: Nq == Nk >= 1024
            d = ch // heads
            calls += [(unet_batch, n, heads, d)] + [(unet_batch // 2, n, heads, d)] * (2 if cfg.multimodal else 0)
    return calls


def unet_norm_calls(cfg, unet_batch: int):
    """(B, C, H, W) of every fused GroupNorm + SiLU call of one UNet forward."""
    mc, size, nrb = cfg.unet_channels, cfg.latent_size, cfg.unet_num_res_blocks
    mults = list(cfg.unet_channel_mult)
    calls, skips, ch, ds = [], [mc], mc, 1

    def res(cin, cout, ds):
        s = size // ds
        calls.extend([(unet_batch, cin, s, s), (unet_batch, cout, s, s)])

    for level, mult in enumerate(mults):
        for _ in range(nrb):
            res(ch, mult * mc, ds)
            ch = mult * mc
            skips.append(ch)
        if level != len(mults) - 1:
            skips.append(ch)
            ds *= 2
    res(ch, ch, ds)
    res(ch, ch, ds)
    for level, mult in reversed(list(enumerate(mults))):
        for i in range(nrb + 1):
            res(ch + skips.pop(), mc * mult, ds)
            ch = mc * mult
            if level and i == nrb:
                ds //= 2
    calls.append((unet_batch, ch, size, size))
    return calls


def launch_counts(**launched):
    """Every kernel's launch count: 0 but for those named."""
    from mobi_tpu_torch.ops import _build

    return {**dict.fromkeys(_build.launches, 0), **launched}


def check_close(name, out, ref, atol, rtol):
    """(max abs error, max of error / tolerance) of out against ref."""
    import torch

    err = (out.float() - ref.float()).abs()
    ratio = (err / (atol + rtol * ref.float().abs())).max().item()
    if not bool(torch.isfinite(out.float()).all()) or ratio > 1:
        raise AssertionError(f"{name}: kernel disagrees with its plain version, max abs err "
                             f"{err.max().item()}, {ratio} x the tolerance")
    return err.max().item(), ratio


def flash_inputs(g, dev, case, b, nq, nk, h, d, dtype=None):
    """q, k, v for one kernel row: random, or the edge cases' own."""
    import torch

    dtype = dtype or torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    if case == "extreme_logits":  # tests/test_flash_attention.py:30-39
        q = torch.full((b, nq, h, d), 8.0, device=dev, dtype=dtype)
        return q, randn(b, nk, h, d, scale=8.0), randn(b, nk, h, d)
    if case == "strided_views":  # q, k, v of one fused [B, N, 3, H, D] projection
        return randn(b, nq, 3, h, d).unbind(2)
    return randn(b, nq, h, d), randn(b, nk, h, d), randn(b, nk, h, d)


def flash_rows(name, fn, cases, g, dev, dtype=None, fp32=False, other=None):
    """Rows of a flash forward kernel `fn` against `attention_plain`, with
    times and bound at the main-path shapes. fp32: atol F32_ATOL, the bound
    at 3x the flops at the TF32 rate, and the TF32 control. `other`: a second kernel whose difference from this
    one on the same inputs is reported. Returns (every row, the main-path
    rows by (B, N, H, D))."""
    import torch
    import torch.nn.functional as F

    from mobi_tpu_torch.ops import flash_attention as fa

    rows, per_shape = [], {}
    for (b, nq, nk, h, d), case in cases.items():
        q, k, v = flash_inputs(g, dev, case, b, nq, nk, h, d, dtype)
        out = fn(q, k, v)
        torch.cuda.synchronize()
        ref = fa.attention_plain(q, k, v)
        atol, rtol = (F32_ATOL, 0.0) if fp32 else (K1_ATOL_STD * ref.float().std().item(), K1_RTOL)
        err, ratio = check_close(f"{name} {case} {(b, nq, nk, h, d)}", out, ref, atol, rtol)
        row = {"phase": "kernel", "name": name, "dtype": str(q.dtype).replace("torch.", ""),
               "shape_b_nq_nk_h_d": [b, nq, nk, h, d], "case": case, "max_abs_err": err,
               "atol": atol, "rtol": rtol, "err_over_tol": ratio}
        if fp32 and case == "main_path":
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                ctl = fa.attention_plain(q, k, v)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            row["tf32_control_max_abs_err"] = float((ctl - ref).abs().max())
            del ctl
            if row["tf32_control_max_abs_err"] <= atol:
                raise AssertionError(f"{name} {case}: the plain version in TF32 passes the fp32 "
                                     f"tolerance {atol}, so the check cannot tell fp32 from TF32")
        if other is not None:
            row["max_abs_diff_vs_" + other.__name__] = float((out.float() - other(q, k, v).float()).abs().max())
        if case in TIMED_CASES:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            flops = 4 * b * h * nq * nk * d
            row["ms"] = cuda_ms(lambda: fn(q, k, v), 20)
            row["plain_ms"] = cuda_ms(lambda: fa.attention_plain(q, k, v), 3, warmup=1)
            row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
            row["bound_ms"], row["bound_by"] = bound(
                3 * flops if fp32 else flops, b * h * nq * nk, q.element_size() * 4 * b * nq * h * d,
                peak_flops=PEAK_TF32_FLOPS if fp32 else PEAK_BF16_FLOPS)
            row["tflops"] = flops / row["ms"] / 1e9
            if case == "main_path":
                per_shape[(b, nq, h, d)] = row
            del qt, kt, vt
        emit(row)
        rows.append(row)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return rows, per_shape


def head_dim_rows(rows):
    """The timed rows off the main path's head dims, as the kernels line
    lists them."""
    keys = ("dtype", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err", "err_over_tol")
    return [{"shape_b_nq_nk_h_d": r["shape_b_nq_nk_h_d"], **{k: r[k] for k in keys if k in r},
             "bound_share": r["bound_ms"] / r["ms"]}
            for r in rows if r["case"] == "head_dim"]


def kernel_entry(name, source, replaces, rows, per_shape, calls, per):
    """The kernels-line entry of one kernel: worst error over `rows`, times
    summed over the main path's `calls` (shapes keyed as in per_shape)."""
    kern = {"name": name, "route": "cuda", "source": source, "replaces": replaces, "per": per,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "err_over_tol": max(r["err_over_tol"] for r in rows), "head_dims": head_dim_rows(rows)}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        kern[key] = sum(per_shape[c][key] for c in calls)
    kern["bound_by"] = max(per_shape.values(), key=lambda r: r["bound_ms"])["bound_by"]
    return kern


def phase_kernels(cfg, unet_batch: int):
    """K1 and K2 (flash forward, and with the transposed accumulator) and K6
    (fused GroupNorm + SiLU) against their plain versions at the flagship's
    shapes and at edge cases, in bf16; then K1, K2 and K6 in fp32 at the
    flagship's largest shapes."""
    import torch
    import torch.nn.functional as F

    from mobi_tpu_torch.ops import flash_attention as fa
    from mobi_tpu_torch.ops import fused_norm as fn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    flash_calls = unet_flash_calls(cfg, unet_batch)
    # nq_ne_nk cuts the third 128-key tile, short_keys has fewer keys than one
    edges = {(1, 256, 256, 2, 40): "extreme_logits", (2, 1000, 1000, 8, 40): "ragged_n",
             (2, 1024, 300, 8, 40): "nq_ne_nk", (2, 1024, 1024, 8, 40): "strided_views",
             (2, 1024, 100, 8, 40): "short_keys"}

    def main_cases(calls):
        return {(b, n, n, h, d): "main_path" for b, n, h, d in sorted(set(calls), key=calls.index)}

    head_dims = {(b, n, n, h, d): "head_dim" for b, n, h, d in HEAD_DIM_SHAPES}
    rows, per_shape = flash_rows("flash_fwd", fa.flash_fwd, {**main_cases(flash_calls), **edges, **head_dims},
                                 g, dev)
    k1 = kernel_entry("flash_fwd", "mobi_tpu_torch/csrc/flash_fwd_sm90.cu",
                      "mobi_tpu/ops/flash_attention.py:106", rows, per_shape,
                      flash_calls, f"one UNet forward at batch {unet_batch} ({len(flash_calls)} launches)")

    # ---- K2 at the d < 64 calls of the forward (the switch's path) + edges
    tav_calls = [c for c in flash_calls if c[3] < fa.TAV_MAX_HEAD_DIM]
    tav_head_dims = {(b, n, n, h, d): "head_dim" for b, n, h, d in TAV_HEAD_DIM_SHAPES}
    rows, per_shape = flash_rows("flash_fwd_tav", fa.flash_fwd_tav,
                                 {**main_cases(tav_calls), **edges, **tav_head_dims}, g, dev, other=fa.flash_fwd)
    k2 = kernel_entry("flash_fwd_tav", "mobi_tpu_torch/csrc/flash_fwd_sm90.cu",
                      "mobi_tpu/ops/flash_attention.py:56", rows, per_shape,
                      tav_calls, f"one UNet forward at batch {unet_batch} with the K2 switch on "
                                 f"({len(tav_calls)} launches; K1 takes the d = 80 calls)")
    k2["max_abs_diff_vs_flash_fwd"] = max(r["max_abs_diff_vs_flash_fwd"] for r in rows)
    k2["plain"] = "attention_plain (K1's plain version)"

    # ---- K6: fused GroupNorm + SiLU at every ResBlock norm of the UNet
    norm_calls = unet_norm_calls(cfg, unet_batch)

    def gn_row(b, c, hh, ww, dtype, atol, rtol, case="main_path"):
        x = (torch.randn(b, c, hh, ww, generator=g, device=dev) * 2.0).to(dtype) + 0.5
        w = (torch.rand(c, generator=g, device=dev) + 0.5)
        bias = torch.randn(c, generator=g, device=dev)
        groups = min(32, c)
        out = fn.fused_groupnorm_silu(x, w, bias, groups, 1e-5)
        torch.cuda.synchronize()
        ref = fn.groupnorm_silu_plain(x, w, bias, groups, 1e-5)
        err, ratio = check_close(f"gn_silu {(b, c, hh, ww)} {dtype}", out, ref, atol, rtol)
        plan = fn.gn_plan(b, c, groups, hh * ww, x.element_size())
        # the first port's design (one block a span, two reads), now the
        # streaming variant: timed here beside the plan's, not a kernels-line number
        first = fn.GnPlan("stream", 1, c // groups * hh * ww, fn.GN_STREAM_THREADS)
        row = {"phase": "kernel", "name": "gn_silu", "dtype": str(dtype).replace("torch.", ""),
               "shape_bchw": [b, c, hh, ww], "case": case, "plan": list(dataclasses.astuple(plan)),
               "max_abs_err": err, "atol": atol, "rtol": rtol, "err_over_tol": ratio,
               "ms": cuda_ms(lambda: fn.fused_groupnorm_silu(x, w, bias, groups, 1e-5), 50),
               "first_design_ms": cuda_ms(lambda: fn._gn_silu_cuda(x, w, bias, groups, 1e-5, first), 50),
               # moving the same bytes with no arithmetic: the practical floor under the bound
               "copy_ms": cuda_ms(lambda: out.copy_(x), 50),
               "plain_ms": cuda_ms(lambda: fn.groupnorm_silu_plain(x, w, bias, groups, 1e-5), 10),
               "library_ms": cuda_ms(
                   lambda: F.silu(F.group_norm(x, groups, w.to(x.dtype), bias.to(x.dtype), 1e-5)), 50)}
        row["bound_ms"], row["bound_by"] = bound(0, 0, 2 * x.element_size() * x.numel())
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["gbps"] = 2 * x.element_size() * x.numel() / row["ms"] / 1e6
        emit(row)
        return row

    per_shape = {s: gn_row(*s, torch.bfloat16, K6_ATOL, K6_RTOL)
                 for s in sorted(set(norm_calls), key=norm_calls.index)}
    spans = [gn_row(*s, torch.bfloat16, K6_ATOL, K6_RTOL, "span") for s in GN_SPAN_SHAPES]
    k6 = kernel_entry("gn_silu", "mobi_tpu_torch/csrc/gn_silu.cu", "mobi_tpu/ops/fused_norm.py:45",
                      list(per_shape.values()) + spans, per_shape, norm_calls,
                      f"one UNet forward at batch {unet_batch} ({len(norm_calls)} launches)")
    k6["spans"] = [{k: r[k] for k in ("dtype", "shape_bchw", "plan", "ms", "plain_ms", "library_ms", "bound_ms",
                                      "max_abs_err", "err_over_tol")} for r in spans]
    emit({"phase": "gn_silu_per_forward", "per": k6["per"], "ms": k6["ms"], "bound_ms": k6["bound_ms"],
          "bound_share": k6["bound_ms"] / k6["ms"],
          "first_design_ms": sum(per_shape[c]["first_design_ms"] for c in norm_calls),
          "copy_ms": sum(per_shape[c]["copy_ms"] for c in norm_calls),
          "slower_than_first_design": [list(s) for s, r in per_shape.items() if r["ms"] > r["first_design_ms"]]})

    # ---- fp32: K1 at batch 8 of both levels, K2 at d = 40, K6 at the widest
    # norm; and each at the head dims and span off the main path
    f32_cases = {(b, n, n, h, d): "main_path" for b, n, h, d in sorted(set(flash_calls))
                 if b == unet_batch}
    fp32 = {"flash_fwd": flash_rows("flash_fwd", fa.flash_fwd, {**f32_cases, **head_dims}, g, dev,
                                    torch.float32, fp32=True)[0],
            "flash_fwd_tav": flash_rows("flash_fwd_tav", fa.flash_fwd_tav,
                                        {**{c: v for c, v in f32_cases.items() if c[4] < fa.TAV_MAX_HEAD_DIM},
                                         **tav_head_dims}, g, dev, torch.float32, fp32=True)[0]}
    widest = max(set(norm_calls), key=lambda s: s[0] * s[1] * s[2] * s[3])
    fp32["gn_silu"] = [gn_row(*widest, torch.float32, K6_F32_ATOL, K6_F32_RTOL)] + [
        gn_row(*s, torch.float32, K6_F32_ATOL, K6_F32_RTOL, "span") for s in GN_SPAN_SHAPES]
    sources = {"flash_fwd": "mobi_tpu_torch/csrc/flash_fwd.cu",
               "flash_fwd_tav": "mobi_tpu_torch/csrc/flash_fwd_tav.cu",
               "gn_silu": "mobi_tpu_torch/csrc/gn_silu.cu"}
    for kern in (k1, k2, k6):
        kern["fp32"] = [{"source": sources[kern["name"]],
                         **{k: v for k, v in r.items() if k not in ("phase", "name")}}
                        for r in fp32[kern["name"]]]
    k1["host_us_per_call"] = host_cost(g, dev)
    torch.cuda.empty_cache()
    return k1, k2, k6


def host_cost(g, dev, calls: int = 2000):
    """Host microseconds per K1 call on a tiny shape, where the card keeps
    up and the time is the wrapper's: bf16 (the TMA kernel: three tensor
    maps encoded per call) against fp32 (the mma.sync kernel: none)."""
    import torch

    from mobi_tpu_torch.ops import flash_attention as fa

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(1, 128, 1, 40, generator=g, device=dev).to(dtype)
        for _ in range(10):
            fa.flash_fwd(q, q, q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fa.flash_fwd(q, q, q)
        out[str(dtype).replace("torch.", "")] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    emit({"phase": "host_overhead", "k1_host_us_per_call": out,
          "bf16_minus_fp32_us": out["bfloat16"] - out["float32"]})
    return out


def train_flash_calls(cfg, unet_batch: int, backend: str = "auto"):
    """(B, N, H, D) of the flash calls of one adapter-only training forward
    that carry a gradient: every call but the first, input_blocks.1's attn1,
    whose q, k and v come from frozen layers and a latent input only (every
    later call sees an adapter's output). That one runs K1."""
    return unet_flash_calls(cfg, unet_batch, backend)[1:]


def phase_train_kernels(cfg, unet_batch: int):
    """K3, K4 and K5 against their plain versions at every flash shape of
    the training step and at edge cases; times at the training shapes."""
    import torch
    import torch.nn.functional as F

    from mobi_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    calls = train_flash_calls(cfg, unet_batch)
    cases = {(b, n, n, h, d): "main_path" for b, n, h, d in sorted(set(calls), key=calls.index)}
    # ragged_both: neither N divides any tile; single_key: less than one tile
    cases.update({(1, 256, 256, 2, 40): "extreme_logits", (2, 1000, 1000, 8, 40): "ragged_n",
                  (2, 1024, 300, 8, 80): "nq_ne_nk", (2, 1024, 1024, 8, 40): "strided_views",
                  (2, 130, 77, 4, 80): "ragged_both", (1, 64, 1, 2, 40): "single_key",
                  **{(b, n, n, h, d): "head_dim" for b, n, h, d in HEAD_DIM_SHAPES}})
    rows = {"flash_fwd_lse": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for (b, nq, nk, h, d), case in cases.items():
        if case == "extreme_logits":  # tests/test_flash_attention.py:184-201
            q = torch.full((b, nq, h, d), 8.0, device=dev, dtype=torch.bfloat16)
            k, v = randn(b, nk, h, d, scale=8.0), randn(b, nk, h, d)
        elif case == "strided_views":  # q, k, v of one fused [B, N, 3, H, D] projection
            q, k, v = randn(b, nq, 3, h, d).unbind(2)
        else:
            q, k, v = randn(b, nq, h, d), randn(b, nk, h, d), randn(b, nk, h, d)
        # dO as a [B, H, N, D] tensor seen as [B, N, H, D] in the strided case
        do = randn(b, h, nq, d).transpose(1, 2) if case == "strided_views" else randn(b, nq, h, d)
        o, lse = fa.flash_fwd_lse(q, k, v)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.attention_lse_plain(q, k, v)
        err_o, ratio_o = check_close(f"flash_fwd_lse o {case}", o, ref_o,
                                     K1_ATOL_STD * ref_o.float().std().item(), K1_RTOL)
        err_l, ratio_l = check_close(f"flash_fwd_lse lse {case}", lse, ref_lse, LSE_ATOL, LSE_RTOL)
        # the backward kernels take the plain forward's o and lse, so each
        # is held against its own plain version alone
        delta = fa.flash_bwd_delta(ref_o, do)
        args = (q, k, v, do, ref_lse, delta)
        dq = fa.flash_bwd_dq(*args)
        dk, dv = fa.flash_bwd_dkv(*args)
        again = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)):
            raise AssertionError(f"flash_bwd {case} {(b, nq, nk, h, d)}: a second run differs")
        del again

        scale = max(1.0, *(t.float().pow(2).mean().sqrt().item() for t in (q, k)))

        def check_bwd(name, out, ref):
            atol = BWD_ATOL_STD * ref.float().std().item() + BWD_ATOL_MIN * scale
            return check_close(f"{name} {case}", out, ref, atol, BWD_RTOL)

        err_q, ratio_q = check_bwd("flash_bwd_dq", dq, fa.flash_bwd_dq_plain(*args))
        (err_k, ratio_k), (err_v, ratio_v) = (
            check_bwd(f"flash_bwd_dkv {n}", out, ref)
            for n, out, ref in zip("kv", (dk, dv), fa.flash_bwd_dkv_plain(*args)))
        base = {"phase": "kernel", "dtype": "bfloat16", "shape_b_nq_nk_h_d": [b, nq, nk, h, d], "case": case}
        new = {"flash_fwd_lse": dict(base, name="flash_fwd_lse", max_abs_err=max(err_o, err_l),
                                     max_abs_err_o=err_o, max_abs_err_lse=err_l,
                                     err_over_tol=max(ratio_o, ratio_l)),
               "flash_bwd_dq": dict(base, name="flash_bwd_dq", max_abs_err=err_q, err_over_tol=ratio_q),
               "flash_bwd_dkv": dict(base, name="flash_bwd_dkv", max_abs_err=max(err_k, err_v),
                                     err_over_tol=max(ratio_k, ratio_v))}
        if case in TIMED_CASES:
            n2, bh = nq * nk, b * h
            qkv_bytes = 2 * (b * nq * h * d + 2 * b * nk * h * d)
            stat_bytes = 4 * bh * nq
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qt, kt, vt)
            dot = do.transpose(1, 2).contiguous()
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True), 20)
            r = new["flash_fwd_lse"]
            r["ms"] = cuda_ms(lambda: fa.flash_fwd_lse(q, k, v), 20)
            r["plain_ms"] = cuda_ms(lambda: fa.attention_lse_plain(q, k, v), 3, warmup=1)
            with torch.no_grad():
                r["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
            r["bound_ms"], r["bound_by"] = bound(4 * bh * n2 * d, bh * n2,
                                                 qkv_bytes + 2 * b * nq * h * d + stat_bytes)
            r = new["flash_bwd_dq"]
            r["ms"] = cuda_ms(lambda: fa.flash_bwd_dq(*args), 20)
            r["plain_ms"] = cuda_ms(lambda: fa.flash_bwd_dq_plain(*args), 3, warmup=1)
            r["bound_ms"], r["bound_by"] = bound(6 * bh * n2 * d, bh * n2,
                                                 qkv_bytes + 4 * b * nq * h * d + 2 * stat_bytes)
            r = new["flash_bwd_dkv"]
            r["ms"] = cuda_ms(lambda: fa.flash_bwd_dkv(*args), 20)
            r["plain_ms"] = cuda_ms(lambda: fa.flash_bwd_dkv_plain(*args), 3, warmup=1)
            r["bound_ms"], r["bound_by"] = bound(8 * bh * n2 * d, bh * n2,
                                                 qkv_bytes + 2 * b * nq * h * d + 2 * stat_bytes
                                                 + 4 * b * nk * h * d)
            # one SDPA backward computes dq, dk and dv together: the
            # yardstick of K4 + K5, given on both rows
            new["flash_bwd_dq"]["library_ms"] = new["flash_bwd_dkv"]["library_ms"] = lib_bwd
            for name in MMA_SYNC_BWD_MS:
                new[name]["was_ms"] = MMA_SYNC_BWD_MS[name].get((b, nq, h, d))
            del qt, kt, vt, sdpa
        for name, row in new.items():
            rows[name][(b, nq, nk, h, d, case)] = row
            emit(row)
        del q, k, v, do, o, lse, ref_o, ref_lse, delta, args, dq, dk, dv
        torch.cuda.empty_cache()

    per = f"one training step at UNet batch {unet_batch} ({len(calls)} launches)"
    meta = {"flash_fwd_lse": ("mobi_tpu_torch/csrc/flash_fwd_sm90.cu", "mobi_tpu/ops/flash_attention.py:228"),
            "flash_bwd_dq": ("mobi_tpu_torch/csrc/flash_bwd_sm90.cu", "mobi_tpu/ops/flash_attention.py:303"),
            "flash_bwd_dkv": ("mobi_tpu_torch/csrc/flash_bwd_sm90.cu", "mobi_tpu/ops/flash_attention.py:335")}
    out = []
    for name, by_case in rows.items():
        main = {(b, nq, h, d): r for (b, nq, _, h, d, case), r in by_case.items()
                if case == "main_path"}
        kern = {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
                "per": per, "max_abs_err": max(r["max_abs_err"] for r in by_case.values()),
                "err_over_tol": max(r["err_over_tol"] for r in by_case.values()),
                "head_dims": head_dim_rows(by_case.values())}
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            kern[key] = sum(main[(bb, n, hh, dd)][key] for bb, n, hh, dd in calls)
        kern["bound_by"] = max(main.values(), key=lambda r: r["bound_ms"])["bound_by"]
        out.append(kern)
    emit({"phase": "train_kernels_per_step", "per": per,
          **{k["name"]: {key: k[key] for key in ("ms", "bound_ms", "library_ms")} for k in out},
          "was_ms_not_measured_here": {
              "flash_fwd_lse": MMA_SYNC_K3_MS_PER_STEP,
              **{name: sum(ms[c] for c in calls) for name, ms in MMA_SYNC_BWD_MS.items()}}})
    return out


def phase_train_kernels_fp32(cfg, unet_batch: int, calls=None, head_dims: bool = True):
    """K3, K4 and K5 in fp32 (3xTF32) against their fp32 plain versions
    (TF32 off) at the flash shapes of the training step (or at `calls`,
    (B, N, H, D) each), each with the plain version in TF32 as a control
    that must fail the tolerance; times, and the bound at 3x the flops at
    the TF32 rate; the head dims off the main path unless not `head_dims`.
    Returns the rows by kernel."""
    import torch
    import torch.nn.functional as F

    from mobi_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)

    def tf32(fn, *args):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn(*args)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def check(name, out, ref, ctl, atol):
        err, ratio = check_close(name, out, ref, atol, 0.0)
        ctl_err = float((ctl.float() - ref.float()).abs().max())
        if ctl_err <= atol:
            raise AssertionError(f"{name}: the plain version in TF32 passes the fp32 tolerance {atol}, "
                                 "so the check cannot tell fp32 from TF32")
        return {"max_abs_err": err, "atol": atol, "err_over_tol": ratio, "tf32_control_max_abs_err": ctl_err}

    calls = calls or train_flash_calls(cfg, unet_batch)
    rows = {"flash_fwd_lse": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}
    cases = {**{c: "main_path" for c in sorted(set(calls), key=calls.index)},
             **{c: "head_dim" for c in (HEAD_DIM_SHAPES if head_dims else ())}}
    for (b, n, h, d), case in cases.items():
        q, k, v, do = (torch.randn(b, n, h, d, generator=g, device=dev) for _ in range(4))
        scale = max(1.0, *(t.pow(2).mean().sqrt().item() for t in (q, k)))
        o, lse = fa.flash_fwd_lse(q, k, v)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.attention_lse_plain(q, k, v)
        ctl_o = tf32(fa.attention_lse_plain, q, k, v)[0]
        row_o = check(f"flash_fwd_lse fp32 o {(b, n, h, d)}", o, ref_o, ctl_o,
                      F32_ATOL_STD * ref_o.std().item() + F32_ATOL_MIN)
        err_l, ratio_l = check_close(f"flash_fwd_lse fp32 lse {(b, n, h, d)}", lse, ref_lse, LSE_F32_ATOL, 0.0)
        delta = fa.flash_bwd_delta(ref_o, do)
        args = (q, k, v, do, ref_lse, delta)
        got = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
        torch.cuda.synchronize()
        ref = fa.flash_bwd_plain(q, k, v, ref_o, ref_lse, do)
        ctl = tf32(fa.flash_bwd_plain, q, k, v, ref_o, ref_lse, do)
        grad = {nm: check(f"{nm} fp32 {(b, n, h, d)}", a, r, c,
                          F32_ATOL_STD * r.std().item() + F32_ATOL_MIN * scale)
                for nm, a, r, c in zip(("dq", "dk", "dv"), got, ref, ctl)}
        del ref, ctl, ctl_o
        torch.cuda.empty_cache()

        n2, bh = n * n, b * h
        io = 4 * b * n * h * d  # bytes of one [B, N, H, D] fp32 tensor
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2).contiguous()
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True), 5)
        with torch.no_grad():
            lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 5)
        del qt, kt, vt, sdpa, dot
        base = {"phase": "kernel", "dtype": "float32", "shape_b_nq_nk_h_d": [b, n, n, h, d],
                "case": case}
        r3 = dict(base, name="flash_fwd_lse", **row_o, max_abs_err_lse=err_l, lse_atol=LSE_F32_ATOL,
                  ms=cuda_ms(lambda: fa.flash_fwd_lse(q, k, v), 5),
                  plain_ms=cuda_ms(lambda: fa.attention_lse_plain(q, k, v), 2, warmup=1), library_ms=lib_fwd)
        r3["err_over_tol"] = max(r3["err_over_tol"], ratio_l)
        r3["bound_ms"], r3["bound_by"] = bound(3 * 4 * bh * n2 * d, bh * n2, 4 * io + 4 * bh * n,
                                               peak_flops=PEAK_TF32_FLOPS)
        r4 = dict(base, name="flash_bwd_dq", **grad["dq"], ms=cuda_ms(lambda: fa.flash_bwd_dq(*args), 5),
                  plain_ms=cuda_ms(lambda: fa.flash_bwd_dq_plain(*args), 2, warmup=1), library_ms=lib_bwd)
        r4["bound_ms"], r4["bound_by"] = bound(3 * 6 * bh * n2 * d, bh * n2, 5 * io + 8 * bh * n,
                                               peak_flops=PEAK_TF32_FLOPS)
        worst = max((grad["dk"], grad["dv"]), key=lambda r: r["err_over_tol"])
        r5 = dict(base, name="flash_bwd_dkv", **worst, max_abs_err_dk=grad["dk"]["max_abs_err"],
                  max_abs_err_dv=grad["dv"]["max_abs_err"], ms=cuda_ms(lambda: fa.flash_bwd_dkv(*args), 5),
                  plain_ms=cuda_ms(lambda: fa.flash_bwd_dkv_plain(*args), 2, warmup=1), library_ms=lib_bwd)
        r5["bound_ms"], r5["bound_by"] = bound(3 * 8 * bh * n2 * d, bh * n2, 6 * io + 8 * bh * n,
                                               peak_flops=PEAK_TF32_FLOPS)
        for r in (r3, r4, r5):
            emit(r)
            rows[r["name"]].append({"source": ("mobi_tpu_torch/csrc/flash_fwd.cu" if r is r3 else
                                               "mobi_tpu_torch/csrc/flash_bwd.cu"),
                                    **{key: val for key, val in r.items()
                                       if key not in ("phase", "name")}})
        del q, k, v, do, o, lse, ref_o, ref_lse, delta, args, got
        torch.cuda.empty_cache()
    return rows


def make_batch(pairs: int, size: int = 512, camera_only: bool = False):
    """Seeded inputs in the NuScenes batch schema (NHWC), as bench.py's, at
    `size` x `size`; `camera_only` stops after the reference image (the
    camera-only model reads no bbox and no lidar)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    f32 = np.float32

    def u(*shape):
        return rng.uniform(-1, 1, shape).astype(f32)

    image = {"GT": u(pairs, size, size, 3), "inpaint_image": u(pairs, size, size, 3),
             "inpaint_mask": np.ones((pairs, size, size, 1), f32), "cond": {"ref_image": u(pairs, 224, 224, 3)}}
    if camera_only:
        return {"image": image}
    return {
        "image": {
            **image,
            "cond": {**image["cond"], "ref_bbox": rng.uniform(0, 1, (pairs, 8, 3)).astype(f32)},
        },
        "lidar": {
            "range_data": u(pairs, size, size, 2),
            "range_data_inpaint": u(pairs, size, size, 2),
            "range_mask": np.ones((pairs, size, size, 1), f32),
            "cond": {"ref_bbox": rng.uniform(0, 1, (pairs, 8, 3)).astype(f32)},
        },
    }


def phase_flagship(model, smi: str):
    """The main path, counted: one batch with the defaults (flash attention,
    GroupNorm then SiLU), timed batches, and one batch with the fused
    GroupNorm + SiLU switch on (the path of the gn_silu kernel)."""
    import torch

    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.pipeline import make_inpaint_pipeline

    pipeline = make_inpaint_pipeline(model, num_steps=STEPS, guidance_scale=GUIDANCE, sampler="ddim")
    batch = make_batch(PAIRS)
    gen = torch.Generator(device=model.device)
    per_forward = {"flash_fwd": len(unet_flash_calls(model.config, 4 * PAIRS)),
                   "gn_silu": len(unet_norm_calls(model.config, 4 * PAIRS))}

    def counted(fused: bool):
        model.unet.set_fused_gn(fused)
        gen.manual_seed(SEED)
        _build.reset_launches()
        out = pipeline(batch, gen)
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        model.unet.set_fused_gn(False)
        want = launch_counts(flash_fwd=STEPS * per_forward["flash_fwd"],
                             gn_silu=STEPS * per_forward["gn_silu"] if fused else 0)
        if counts != want:
            raise AssertionError(f"flagship (fused_gn={fused}) launches {counts}, expected {want}")
        for name, shape in (("camera", (PAIRS, 512, 512, 3)), ("lidar", (PAIRS, 512, 512, 2))):
            t = out[name]
            if tuple(t.shape) != shape or not bool(torch.isfinite(t.float()).all()):
                raise AssertionError(f"flagship {name}: shape {tuple(t.shape)} (want {shape}) or non-finite")
        return out, counts

    torch.cuda.reset_peak_memory_stats()  # the kernel phase's plain attention peaks higher
    out, counts = counted(False)
    stats = {name: [float(out[name].float().mean()), float(out[name].float().std())] for name in out}
    walls = []
    for i in range(TIMED_BATCHES):
        gen.manual_seed(SEED + 1 + i)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pipeline(batch, gen)
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end) / 1e3)
    med = statistics.median(walls)
    emit({"phase": "flagship", "pairs": PAIRS, "steps": STEPS, "guidance": GUIDANCE,
          "launches": counts, "output_mean_std": stats, "batch_s": walls,
          "median_batch_s": med, "inpaints_per_hour": PAIRS / med * 3600.0,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": smi})

    phase_profile(model, batch, gen, med)
    out_fused, counts_fused = counted(True)
    diff = {name: float((out_fused[name].float() - out[name].float()).abs().max())
            for name in out}
    emit({"phase": "flagship_fused_gn", "launches": counts_fused,
          "max_abs_diff_vs_default": diff})
    return counts, counts_fused


KERNEL_CLASSES = (  # (class, substrings of the CUDA kernel name), first match wins
    # fp32 K3; bf16 K3 is K1's sm90 kernel with its lse output, so in bf16
    # the flash_fwd class holds both
    ("flash_fwd_lse", tuple(f"flash_fwd_kernel<{dk}, {dv}, true"
                            for dk, dv in ((48, 48), (64, 64), (80, 80), (128, 128), (160, 80), (192, 64),
                                           (256, 64)))),
    ("flash_fwd_tav", ("flash_fwd_tav_kernel", "flash_fwd_sm90_kernel<48, 48, true",
                       "flash_fwd_sm90_kernel<64, 64, true")),
    ("flash_fwd", ("flash_fwd_kernel", "flash_fwd_sm90_kernel")),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_sm90_kernel")),
    ("flash_bwd_dkv", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_sm90_kernel")),
    ("gn_silu", ("gn_silu_",)),
    ("conv", ("conv", "cudnn", "implicit", "xmma", "fprop", "dgrad", "nchwToNhwc", "nhwcToNchw")),
    ("matmul", ("gemm", "cutlass", "nvjet", "cublas", "sm90_", "splitK")),
    ("softmax", ("softmax",)),
    ("norm_reduce", ("norm", "reduce", "welford", "Reduce")),
    ("copy_cat_permute", ("copy", "cat", "Cat", "transpose", "permute", "index", "upsample")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise", "unrolled")),
)


def profile_classes(fn):
    """Device seconds by kernel class of fn(), and its top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the raw device events summed by name: key_averages() builds a Python
    # object for each of a PLMS-50 batch's ~10^5 events first (~30 s)
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        row = by_name.setdefault(e.name(), [0, 0])
        row[0] += e.duration_ns()
        row[1] += 1
    classes, top = {}, []
    for name, (ns, count) in by_name.items():
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + ns / 1e9
        top.append((ns / 1e9, count, name[:90]))
    return classes, sorted(top, reverse=True)


def phase_profile(model, batch, gen, median_batch_s: float, phase: str = "profile"):
    """Device time by kernel class of a DDIM-STEPS batch (the flagship's, or
    the camera-only model's as `phase`), from two short batches under
    torch.profiler (CUDA activity only): the difference of a 2-step and a
    4-step batch gives each class's time per DDIM step, the rest its time
    outside the steps (encodes, decodes); the batch's is that plus STEPS
    steps. Also the busy share of the unprofiled median wall."""
    from mobi_tpu_torch.pipeline import make_inpaint_pipeline

    (a, b), runs = PROFILE_STEPS, {}
    for steps in PROFILE_STEPS:
        short = make_inpaint_pipeline(model, num_steps=steps, guidance_scale=GUIDANCE, sampler="ddim")
        gen.manual_seed(SEED)
        runs[steps] = profile_classes(lambda: short(batch, gen))
    ca, cb = runs[a][0], runs[b][0]
    est, per_step, fixed = {}, {}, {}
    for cls in set(ca) | set(cb):
        per_step[cls] = (cb.get(cls, 0.0) - ca.get(cls, 0.0)) / (b - a)
        fixed[cls] = ca.get(cls, 0.0) - a * per_step[cls]
        est[cls] = fixed[cls] + STEPS * per_step[cls]
    busy = sum(est.values())
    emit({"phase": phase, "profiled_steps": list(PROFILE_STEPS),
          "device_busy_s_est": busy if busy else None,
          "busy_share_of_median_wall": busy / median_batch_s if busy else None,
          "device_s_by_class_est": dict(sorted(est.items(), key=lambda kv: -kv[1])),
          "device_s_per_step": dict(sorted(per_step.items(), key=lambda kv: -kv[1])),
          "device_s_outside_steps": dict(sorted(fixed.items(), key=lambda kv: -kv[1])),
          f"top_kernels_s_count_{b}_steps": runs[b][1][:12]})


def attention_targets(unet, backend: str):
    """The UNet attentions a variant's backend is set on: "flash", as
    MobiConfig.attn_backend does, the backend-routed ones (each transformer's
    self-attention and its cross-modal attentions; the CLIP and bbox
    attentions keep "auto"); "auto" and "xla" every one."""
    from mobi_tpu_torch.models.unet import CrossAttention

    return [m for name, m in unet.named_modules() if isinstance(m, CrossAttention)
            and (backend != "flash" or name.endswith("attn1") or "cross_modal_attn" in name)]


def unet_switches(model, b: int, tol: float, variants, phase: str):
    """One full-width UNet forward at batch b with each variant (label,
    fused GroupNorm + SiLU, attention backend, K2 switch) against the same
    forward through the plain versions (GroupNorm then SiLU, the plain
    attention formula): relative L2 of eps within `tol`, and the launches
    each variant must make. The backend "flash" sends every routed call to
    the kernels, the d = 160 calls of the 16x16 and 8x8 levels included."""
    import torch

    from mobi_tpu_torch.models.unet import CrossAttention
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.ops import flash_attention as fa

    cfg, unet = model.config, model.unet
    s = cfg.latent_size
    g = torch.Generator(device=model.device).manual_seed(SEED + 100)
    x9 = torch.randn(b, 9, s, s, generator=g, device=model.device)
    t = torch.randint(0, cfg.timesteps, (b,), generator=g, device=model.device)
    ctx = torch.randn(b, len(cfg.cond_stage_key), cfg.context_dim, generator=g, device=model.device)
    attns = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    saved = [m.attn_backend for m in attns]

    def forward(fused: bool, backend: str, tav: bool):
        unet.set_fused_gn(fused)
        fa.set_transposed_av(tav)
        for m in attention_targets(unet, backend):
            m.attn_backend = backend
        _build.reset_launches()
        try:
            with torch.inference_mode():
                eps = unet(x9, t, ctx)
            torch.cuda.synchronize()
        finally:
            unet.set_fused_gn(False)
            fa.set_transposed_av(False)
            for m, was in zip(attns, saved):
                m.attn_backend = was
        return eps, dict(_build.launches)

    ref, n_ref = forward(False, "xla", False)
    if n_ref != launch_counts():
        raise AssertionError(f"{phase}: the plain forward launched {n_ref}")
    results = {"plain": {}}
    for label, fused, backend, tav in variants:
        eps, n = forward(fused, backend, tav)
        rel = float((eps.float() - ref.float()).norm() / ref.float().norm())
        results[label] = {"launches": {k: v for k, v in n.items() if v}, "rel_l2_vs_plain": rel}
        if not bool(torch.isfinite(eps).all()) or rel > tol:
            raise AssertionError(f"{phase} UNet eps {label}: rel L2 {rel} vs the plain versions")
        calls = unet_flash_calls(cfg, b, backend) if backend != "xla" else []
        n_tav = sum(d < fa.TAV_MAX_HEAD_DIM for *_, d in calls) if tav else 0
        want = launch_counts(flash_fwd=len(calls) - n_tav, flash_fwd_tav=n_tav,
                             gn_silu=len(unet_norm_calls(cfg, b)) if fused else 0)
        if n != want:
            raise AssertionError(f"{phase} {label} launches {n}, expected {want}")
    emit({"phase": phase, "dtype": str(cfg.dtype).replace("torch.", ""), "unet_batch": b,
          "tolerance_rel_l2": tol, **results})
    return results


def phase_switches(model):
    """bf16, batch 4 * PAIRS (the CFG-doubled flagship batch): flash
    attention (K1), K2 for the d = 40 calls, the fused norm (K6), both, and
    attn_backend "flash" (K1 at every level, d = 160 included)."""
    return unet_switches(model, 4 * PAIRS, UNET_REL_L2, (
        ("flash", False, "auto", False), ("flash_tav", False, "auto", True),
        ("fused_gn", True, "xla", False), ("both", True, "auto", False),
        ("flash_all", False, "flash", False)), "switches")


def phase_fp32():
    """The default MobiConfig() (fp32) at full width: one UNet forward at
    batch 2 through K1, K2 and K6 in fp32 against the plain versions, then
    the trainable gradients of one training loss at SWITCH_PAIRS pair(s)
    through K1, K3, K4 and K5 in fp32 against the plain path."""
    import torch

    from mobi_tpu_torch import training as T
    from mobi_tpu_torch.models.diffusion import MobiConfig, MobiDiffusion

    # for_training: fp32 everywhere either way; the gradients below need it
    model = MobiDiffusion(MobiConfig(), device="cuda", seed=SEED, for_training=True)
    if model.config.dtype != torch.float32:
        raise AssertionError("MobiConfig() is expected to be fp32")
    unet_switches(model, 2, FP32_UNET_REL_L2, (
        ("flash", False, "auto", False), ("flash_tav", False, "auto", True),
        ("both", True, "auto", False)), "fp32")
    tx = T.make_optimizer(model, schedule=T.lambda_linear_schedule(TRAIN_LR, TRAIN_WARMUP))
    trainable_grads_vs_plain(model, tx, SWITCH_PAIRS, (("kernels", False, "auto", "pallas"),),
                             FP32_GRAD_REL_L2, "fp32_train_grads")
    del model, tx
    torch.cuda.empty_cache()


# The camera-only (Paint-by-Example) model: its batch_size, bench.py's
# inputs at its 256 x 256, DDIM-50 at CFG 5; the gradient gate at
# TRAIN_PAIRS pairs.
CAMERA_ONLY_CONFIG = ROOT / "configs" / "pbe_camera_256.yaml"


def phase_camera_only(smi: str):
    """configs/pbe_camera_256.yaml at full width (UNet 320 x (1, 2, 4, 4),
    VAE 128, CLIP ViT-L/14, one CLIP token, no lidar stage), bf16, seeded
    weights: one DDIM-50 CFG-5 batch of the config's batch_size counted,
    TIMED_BATCHES timed with CUDA events, its device time by kernel class
    (phase_profile), then the counted batch again through the plain
    attention (decoded camera within UNET_REL_L2 relative
    L2; no "lidar" key anywhere). Then the trainable gradients of one
    training loss at TRAIN_PAIRS pairs (injected t, noise, no CFG drop)
    through K3-K5 against the plain attention, within GRAD_REL_L2. The
    camera-only UNet has no adapter, so its adapter-only trainable set is
    `bbox_uncond_vector`, which the loss never reads; the gate trains the
    whole UNet (MOBI_TRAIN_UNET_FULL=1), the set whose backward runs
    K3-K5. Returns the launches of each part."""
    import torch

    from mobi_tpu_torch.models.diffusion import UNET_PREFIX, MobiDiffusion
    from mobi_tpu_torch.models.unet import CrossAttention
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.pipeline import make_inpaint_pipeline
    from mobi_tpu_torch.utils.config import load_config, mobi_config_from_yaml

    t_phase = time.perf_counter()
    tree = load_config([str(CAMERA_ONLY_CONFIG)])
    cfg = mobi_config_from_yaml(tree)
    if cfg.use_lidar or tuple(cfg.cond_stage_key) != ("ref_image",) or cfg.dtype != torch.bfloat16:
        raise AssertionError(f"camera_only: {CAMERA_ONLY_CONFIG.name} parsed to {cfg}")
    size, pairs = cfg.image_height, tree["batch_size"]
    model = MobiDiffusion(cfg, device="cuda", seed=SEED)
    params = sum(p.numel() for p in model.parameters())
    pipeline = make_inpaint_pipeline(model, num_steps=STEPS, guidance_scale=GUIDANCE, sampler="ddim")
    batch = make_batch(pairs, size, camera_only=True)
    gen = torch.Generator(device=model.device)
    per_forward = len(unet_flash_calls(cfg, 2 * pairs))
    attns = [m for m in model.unet.modules() if isinstance(m, CrossAttention)]

    def run(seed: int, backend=None):
        saved = [m.attn_backend for m in attns]
        if backend:
            for m in attns:
                m.attn_backend = backend
        gen.manual_seed(seed)
        _build.reset_launches()
        try:
            out = pipeline(batch, gen)
            torch.cuda.synchronize()
        finally:
            for m, was in zip(attns, saved):
                m.attn_backend = was
        if set(out) != {"camera"} or tuple(out["camera"].shape) != (pairs, size, size, 3) \
                or not bool(torch.isfinite(out["camera"].float()).all()):
            raise AssertionError(f"camera_only: outputs {[(k, tuple(v.shape)) for k, v in out.items()]}")
        return out["camera"].float(), dict(_build.launches)

    torch.cuda.reset_peak_memory_stats()
    cam, counts = run(SEED)
    want = launch_counts(flash_fwd=STEPS * per_forward)
    if counts != want:
        raise AssertionError(f"camera_only launches {counts}, expected {want}")
    walls = []
    for i in range(TIMED_BATCHES):
        gen.manual_seed(SEED + 1 + i)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pipeline(batch, gen)
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end) / 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    phase_profile(model, batch, gen, statistics.median(walls), "camera_only_profile")
    plain, plain_counts = run(SEED, "xla")
    rel = float((cam - plain).norm() / plain.norm())
    if plain_counts != launch_counts() or rel > UNET_REL_L2:
        raise AssertionError(f"camera_only vs the plain attention: rel L2 {rel}, plain launches {plain_counts}")
    del model, pipeline, plain, cam
    torch.cuda.empty_cache()

    # the gradient gate: the whole UNet trainable (fp32 masters, bf16 compute)
    os.environ["MOBI_TRAIN_UNET_FULL"] = "1"
    try:
        model = MobiDiffusion(cfg, device="cuda", seed=SEED, for_training=True)
        mask = model.trainable_mask()
    finally:
        del os.environ["MOBI_TRAIN_UNET_FULL"]
    trained = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name] and name.startswith(UNET_PREFIX):
            trained.append(p)
    b, s = TRAIN_PAIRS, cfg.latent_size
    g = torch.Generator(device=model.device).manual_seed(SEED + 3)
    t = torch.randint(0, cfg.timesteps, (b,), generator=g, device=model.device)
    noise = torch.randn(b, s, s, 4, generator=g, device=model.device).to(cfg.dtype)
    train_batch = make_batch(b, size, camera_only=True)
    attns = [m for m in model.unet.modules() if isinstance(m, CrossAttention)]
    saved = [m.attn_backend for m in attns]

    def grads(backend: str):
        for m in attns:
            m.attn_backend = backend
        g.manual_seed(SEED + 4)  # the same posterior draws both times
        _build.reset_launches()
        try:
            loss, _ = model.training_loss(train_batch, g, t=t, noise=noise, drop=False)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            for m, was in zip(attns, saved):
                m.attn_backend = was
        flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).float().flatten() for p in trained])
        for p in trained:
            p.grad = None
        return flat, loss.item(), dict(_build.launches)

    ref, ref_loss, n_ref = grads("xla")
    got, loss, n = grads(cfg.attn_backend)
    grad_rel = float((got - ref).norm() / ref.norm())
    n_calls = len(unet_flash_calls(cfg, b))
    want_train = launch_counts(flash_fwd_lse=n_calls, flash_bwd_dq=n_calls, flash_bwd_dkv=n_calls)
    line = {"phase": "camera_only", "config": str(CAMERA_ONLY_CONFIG.relative_to(ROOT)), "dtype": "bfloat16",
            "image": size, "latent": s, "context_tokens": len(cfg.cond_stage_key), "parameters": params,
            "pairs": pairs, "unet_batch": 2 * pairs, "steps": STEPS, "guidance": GUIDANCE,
            "launches": {k: v for k, v in counts.items() if v}, "flash_calls_per_forward": per_forward,
            "batch_s": walls, "median_batch_s": statistics.median(walls),
            "inpaints_per_hour": pairs / statistics.median(walls) * 3600.0, "peak_mem_gib": peak,
            "camera_rel_l2_vs_plain_attention": rel, "tolerance_rel_l2": UNET_REL_L2,
            "train": {"pairs": b, "trainable": "whole UNet (MOBI_TRAIN_UNET_FULL=1)",
                      "trainable_elements": int(ref.numel()), "t": t.tolist(), "loss": loss, "plain_loss": ref_loss,
                      "grad_rel_l2_vs_plain": grad_rel, "tolerance_rel_l2": GRAD_REL_L2,
                      "launches": {k: v for k, v in n.items() if v}, "plain_launches": {k: v for k, v in n_ref.items() if v}},
            "phase_s": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    if n != want_train or n_ref != launch_counts() or not bool(torch.isfinite(got).all()) or grad_rel > GRAD_REL_L2:
        raise AssertionError(f"camera_only gradients: {json.dumps(line['train'])}, expected launches {want_train}")
    del model, trained, ref, got
    torch.cuda.empty_cache()
    return {"ddim_batch": counts, "train_loss": n}


def request_samples(n: int):
    """n per-request samples (the batch schema without the batch dim) cut
    from make_batch(n)."""
    def pick(tree, i):
        return {k: pick(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]

    batch = make_batch(n)
    return [pick(batch, i) for i in range(n)]


def check_outputs(name, out, pairs=None):
    """Served (numpy) outputs: camera [512, 512, 3], lidar [512, 512, 2]
    per sample (with a leading `pairs` for a batch), finite."""
    import numpy as np

    for key, ch in (("camera", 3), ("lidar", 2)):
        t = out[key]
        shape = (512, 512, ch) if pairs is None else (pairs, 512, 512, ch)
        if tuple(t.shape) != shape or not np.isfinite(t).all():
            raise AssertionError(f"{name} {key}: shape {tuple(t.shape)} (want {shape}) or non-finite")


def phase_serve(smi: str):
    """The serving path at full width: the service built by the same
    function as `python -m mobi_tpu_torch.serve_http` (MobiConfig in bf16,
    seeded random weights), PLMS-50 CFG-5 at batch_pairs 2. In process: 3
    requests queued before the dispatcher starts make batches [2, 1 + 1
    padded]; counters, launches, per-batch CUDA-event walls, the burst's
    per-request walls, its inpaints/hour and peak memory; the device time of
    one served batch (the service's pipeline and output copy on batch 0's
    inputs, under torch.profiler) and its share of the median batch wall;
    batch 0 and the real
    sample of batch 1 against direct pipeline calls with the generators of
    the service's seeding rule. Then 2 requests over HTTP from 2 threads
    (serve_loadgen's client). Returns (model, direct pipeline, samples,
    batch 0's direct output) for the K2 batch."""
    import threading

    import numpy as np
    import torch

    from mobi_tpu_torch import serve_http, serve_loadgen
    from mobi_tpu_torch.models.diffusion import MobiConfig
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.pipeline import make_inpaint_pipeline
    from mobi_tpu_torch.serve import InpaintService, batch_generator, outputs_to_numpy, stack_samples

    cfg = MobiConfig(dtype=torch.bfloat16)
    kw = dict(num_steps=STEPS, guidance_scale=GUIDANCE, sampler="plms")
    t0 = time.perf_counter()
    svc = serve_http.build_service(cfg, seed=SEED, device="cuda", batch_pairs=SERVE_PAIRS,
                                   max_wait_ms=50, autostart=False, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = svc.model
    samples = request_samples(SERVE_REQUESTS)
    walls, pipeline = [], svc.pipeline

    def timed(batch, generator):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = pipeline(batch, generator)
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end) / 1e3)
        return out

    svc.pipeline = timed
    futures = [svc.submit(x) for x in samples]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    svc.start()
    results = [fut.result(timeout=600) for fut in futures]
    served_s = time.perf_counter() - t0
    svc.stop(timeout=60)
    counts = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_batches = -(-SERVE_REQUESTS // SERVE_PAIRS)
    want = launch_counts(flash_fwd=n_batches * PLMS_EVALS * len(unet_flash_calls(cfg, 4 * SERVE_PAIRS)))
    if counts != want:
        raise AssertionError(f"served batches launched {counts}, expected {want}")
    want_stats = {"batches": n_batches, "samples": SERVE_REQUESTS, "padded": 1, "errors": 0, "rejected": 0}
    if svc.stats != want_stats:
        raise AssertionError(f"service counters {svc.stats}, expected {want_stats}")
    for i, out in enumerate(results):
        check_outputs(f"served request {i}", out)

    direct = make_inpaint_pipeline(model, **kw)
    diffs, ref0 = {}, None
    last = n_batches - 1  # the padded batch: its one real request twice
    for idx, group, served in ((0, samples[0:2], results[0:2]),
                               (last, [samples[-1]] * 2, results[2 * last:])):
        ref = outputs_to_numpy(direct(stack_samples(group), batch_generator(model.device, SEED, idx)))
        ref0 = ref if idx == 0 else ref0
        for i, out in enumerate(served):
            for k in ref:
                diffs[f"batch{idx}_sample{i}_{k}"] = float(np.abs(out[k] - ref[k][i]).max())
    if any(diffs.values()):
        raise AssertionError(f"served outputs differ from the direct pipeline calls: {diffs}")
    lat = svc.latency_stats()
    gen0 = batch_generator(model.device, SEED, 0)
    classes, top = profile_classes(
        lambda: outputs_to_numpy(pipeline(stack_samples(samples[0:2]), gen0)))
    busy = sum(classes.values())
    med = statistics.median(walls)
    emit({"phase": "serve", "pairs_per_batch": SERVE_PAIRS, "requests": SERVE_REQUESTS,
          "sampler": "plms", "steps": STEPS, "guidance": GUIDANCE, "build_s": build_s,
          "stats": svc.stats, "launches": {k: v for k, v in counts.items() if v},
          "batch_s": walls, "median_batch_s": med, "served_s": served_s,
          "burst_inpaints_per_hour": SERVE_REQUESTS / served_s * 3600.0,
          "full_batch_inpaints_per_hour": SERVE_PAIRS / statistics.median(walls[:-1]) * 3600.0,
          **{f"burst_request_{k}": v for k, v in lat.items()},
          "device_busy_s_per_batch": busy, "busy_share_of_median_batch": busy / med,
          "device_s_by_class": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
          "top_kernels_s_count": top[:8],
          "max_abs_diff_vs_direct": max(diffs.values()), "peak_mem_gib": peak, "card": smi})

    # ---- over HTTP: 2 requests from 2 threads, coalesced into one batch
    svc = InpaintService(model, batch_pairs=SERVE_PAIRS, max_wait_ms=2000, rng_seed=SEED, **kw)
    server = serve_http.make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(SEED)
    bodies = [serve_loadgen.encode(serve_loadgen.make_sample(rng, 512, 512)) for _ in range(2)]
    answers, errors = [None, None], []

    def client(i):
        try:
            answers[i] = serve_loadgen.post(f"{base}/inpaint", bodies[i], 600)
        except Exception as e:  # reported and raised below
            errors.append(f"{type(e).__name__}: {e}")

    try:
        health = serve_loadgen.get_json(f"{base}/healthz")
        clients = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        http_s = time.perf_counter() - t0
        stats = serve_loadgen.get_json(f"{base}/stats")
    finally:
        server.shutdown()
        server.server_close()
        svc.stop(timeout=60)
        thread.join(timeout=60)
    if errors or health != {"ok": True}:
        raise AssertionError(f"HTTP: errors {errors}, /healthz {health}")
    for i, (_, out) in enumerate(answers):
        check_outputs(f"HTTP response {i}", out)
    if stats["samples"] != 2 or stats["errors"] != 0:
        raise AssertionError(f"HTTP /stats {stats}")
    emit({"phase": "serve_http", "requests": 2, "clients": 2, "wall_s": http_s,
          "request_s": [a[0] for a in answers], "stats": stats})
    return model, direct, samples, ref0


def phase_plms_tav(model, direct, samples, ref0):
    """Served batch 0 again with the K2 switch on: K2 takes the 15 d = 40
    calls of each of the 51 UNet forwards, K1 the 15 d = 80 ones."""
    import numpy as np
    import torch

    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.ops import flash_attention as fa
    from mobi_tpu_torch.serve import batch_generator, outputs_to_numpy, stack_samples

    calls = unet_flash_calls(model.config, 4 * SERVE_PAIRS)
    n_tav = sum(d < fa.TAV_MAX_HEAD_DIM for *_, d in calls)
    fa.set_transposed_av(True)
    _build.reset_launches()
    try:
        out = outputs_to_numpy(direct(stack_samples(samples[0:2]), batch_generator(model.device, SEED, 0)))
        counts = dict(_build.launches)
    finally:
        fa.set_transposed_av(False)
    want = launch_counts(flash_fwd=PLMS_EVALS * (len(calls) - n_tav), flash_fwd_tav=PLMS_EVALS * n_tav)
    if counts != want:
        raise AssertionError(f"PLMS batch with K2 launched {counts}, expected {want}")
    check_outputs("PLMS batch with K2", out, SERVE_PAIRS)
    diff = {k: float(np.abs(out[k] - ref0[k]).max()) for k in out}
    emit({"phase": "plms_tav", "launches": {k: v for k, v in counts.items() if v},
          "max_abs_diff_vs_default_plms": diff})
    torch.cuda.empty_cache()
    return counts


# The test_bench phase: configs/mobi_nusc_512.yaml's evaluation entry point
# (mobi_tpu_torch/inference_test_bench.py) on a synthetic database at
# nuScenes' camera size, PLMS-50 at CFG 5 with 4 objects a batch.
BENCH_IMG = (1600, 900)
BENCH_ARGS = ["--plms", "--ddim_steps", "50", "--scale", "5", "--n_samples", "4", "--seed", "321",
              "--save_samples", "--save_visualisations"]
BENCH_SEED = 321
BENCH_PAIRS = 4
BENCH_LOADER_SAMPLES = 4  # __getitem__ calls timed one after another
# the files the bench writes for each object (seg = its id name)
BENCH_FILES = ([f"camera/{sub}/{{seg}}_{sub}_seed321.png" for sub in ("object_pred", "object_ref", "patch_gt",
                                                                       "patch_pred")]
               + ["camera/grid/{seg}_grid_seed321.png", "lidar/range_pred/{seg}_range_pred_seed321.npy",
                  "lidar/range_orig/{seg}_range_orig_seed321.npy", "lidar/overlay_orig/{seg}.png",
                  "lidar/overlay_pred/{seg}.png"]
               + [f"lidar/range_{name}_{kind}/{{seg}}_seed321.png" for name in ("depth", "intensity")
                  for kind in ("pred", "target")]
               + [f"lidar/range_{name}_collage/{{seg}}_grid_{name}_seed321.png" for name in ("depth", "intensity")])

def bench_run(bench, model, argv, db, smi, label, profile: bool = False):
    """One inference_test_bench.main run with the launches counted: the
    YAML through PyYAML where it is installed, else BENCH_CONFIG with the
    database's paths. Checks the files of every object and metrics.csv;
    prints the run's line and returns (stats, counts, objects). With
    `profile` the run goes under torch.profiler (CUDA activity only): its
    kernel seconds a batch, their share of the batches' device wall and of
    the run's wall go into the line and into stats["profile"]."""
    import copy
    import csv

    from mobi_tpu_torch.ops import _build

    split = "rotation_test" if "--rotation_test" in argv else "test"
    paths = [f"data.params.{split}.params.{k}={v}" for k, v in db.items()]
    try:
        import yaml  # noqa: F401
        cfg, argv = None, argv + paths
    except ImportError:
        cfg = copy.deepcopy(BENCH_CONFIG)
        cfg["data"]["params"][split]["params"].update(db)
    def run():
        return bench.main(["--config", str(ROOT / "configs" / "mobi_nusc_512.yaml")] + argv, model=model, cfg=cfg)

    _build.reset_launches()
    if profile:
        box = {}
        classes, top = profile_classes(lambda: box.setdefault("stats", run()))
        stats = box["stats"]
    else:
        stats = run()
    counts = dict(_build.launches)
    out = Path(stats["outdir"])
    segs = sorted({p.name[:-len("_grid_seed321.png")] for p in (out / "camera" / "grid").iterdir()})
    missing = [f.format(seg=s) for s in segs for f in BENCH_FILES if not (out / f.format(seg=s)).is_file()]
    frames = sorted(p.name for p in (out / f"samples_seed{BENCH_SEED}").iterdir())
    with open(out / "metrics.csv", newline="") as f:
        rows = list(csv.reader(f))
    metrics = {r[0]: dict(zip(rows[0][1:], map(float, r[1:]))) for r in rows[1:]}
    finite = bool(metrics) and all(math.isfinite(v) for m in metrics.values() for v in m.values())
    if missing or not segs or not finite or len(rows[0]) != 3 or any("" in r for r in rows[1:]):
        raise AssertionError(f"test_bench {label}: missing files {missing[:5]}, objects {segs}, "
                             f"metrics.csv rows {rows}")
    batches = len(stats["batches"])
    per_batch = {k: v / batches for k, v in counts.items() if v}
    if profile:
        busy = sum(classes.values())
        stats["profile"] = {
            "device_kernel_s_per_batch": busy / batches,
            "busy_share_of_device_wall": busy / sum(b["device_s"] for b in stats["batches"]),
            "busy_share_of_run_wall": busy / stats["wall_s"],
            "device_s_by_class": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
            "top_kernels_s_count": top[:8]}
    emit({"phase": "test_bench", "run": label, "config_from": "yaml" if cfg is None else "dict",
          "objects": stats["objects"], "unique_objects": segs, "files_per_object": len(BENCH_FILES),
          "sample_files": frames, "metrics_csv": metrics, "launches": {k: v for k, v in counts.items() if v},
          "launches_per_batch": per_batch,
          "device_s_per_batch": [b["device_s"] for b in stats["batches"]],
          "host_finish_s_per_batch": [b["host_s"] for b in stats["batches"]],
          "wall_s": stats["wall_s"], "objects_per_s": stats["objects"] / stats["wall_s"],
          "profiled": profile, **stats.get("profile", {}), "nvidia_smi": smi})
    return stats, counts, segs


def phase_test_bench(model, smi: str):
    """The evaluation entry point at full width: a synthetic database of 2
    scenes, 3 objects each and 2 erase boxes at 1600 x 900 (the port's
    builder, PNG frames), then inference_test_bench.main with this bf16
    model, PLMS-50 CFG 5, 4 objects a batch: the test split for 2 batches,
    the rotation split for 1 under torch.profiler. Each batch must launch
    K1 (flash_fwd) 51 x the UNet's flash calls (1530) and nothing else.
    Then batch 0 of the test split again, with the same generator seed,
    through the plain attention: the decoded camera and lidar within
    UNET_REL_L2 (relative L2) of the kernels' outputs. Then the test
    split's batch 0 through the bench once more with the K2 and K6
    switches on: K2 takes the d < 64 flash calls, K6 every norm, and the
    outputs stay within UNET_REL_L2 of the plain rerun. Last, the loader's
    seconds a sample (BENCH_LOADER_SAMPLES __getitem__ calls one after
    another)."""
    import shutil

    import torch

    from mobi_tpu_torch import inference_test_bench as bench
    from mobi_tpu_torch.data.synthetic import build_synthetic_database
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.ops import flash_attention as fa
    from mobi_tpu_torch.utils.config import instantiate_from_config

    root = ROOT / "build" / "test_bench"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    db = build_synthetic_database(str(root / "db"), num_scenes=2, objects_per_scene=3, num_erase=2,
                                  img_w=BENCH_IMG[0], img_h=BENCH_IMG[1], seed=SEED)
    build_s = time.perf_counter() - t0
    emit({"phase": "test_bench_db", "seconds": build_s, "frames": BENCH_IMG, "scenes": 2, "objects_per_scene": 3,
          "erase_boxes": 2, "range_view": [32, 1096]})

    make = bench.make_inpaint_pipeline

    def recorded_run(store, argv, label):
        """bench_run with batch 0's stripped inputs, device outputs and the
        pipeline's arguments kept in `store`."""
        def recording(model_, **kw):
            run = make(model_, **kw)

            def call(batch, generator):
                out = run(batch, generator)
                store.setdefault("batch", batch)
                store.setdefault("out", out)
                return out

            store["kw"] = kw
            return call

        bench.make_inpaint_pipeline = recording
        try:
            return bench_run(bench, model, BENCH_ARGS + argv, db, smi, label)
        finally:
            bench.make_inpaint_pipeline = make

    captured = {}
    stats, counts, _ = recorded_run(captured, ["--outdir", str(root / "test"), "--max_batches", "2"], "test")
    calls = unet_flash_calls(model.config, 4 * BENCH_PAIRS)
    want = launch_counts(flash_fwd=len(stats["batches"]) * PLMS_EVALS * len(calls))
    if counts != want or len(stats["batches"]) != 2 or stats["objects"] != 2 * BENCH_PAIRS:
        raise AssertionError(f"test_bench: launches {counts} (want {want}), batches {stats['batches']}")
    rot, rot_counts, _ = bench_run(bench, model, BENCH_ARGS + ["--outdir", str(root / "rotation"), "--rotation_test",
                                                               "--max_batches", "1"], db, smi, "rotation_test",
                                   profile=True)
    if rot_counts != launch_counts(flash_fwd=PLMS_EVALS * len(calls)):
        raise AssertionError(f"test_bench rotation: launches {rot_counts}")
    kernel_s = rot["profile"]["device_kernel_s_per_batch"]
    emit({"phase": "test_bench_busy", "device_kernel_s_per_batch": kernel_s, "profiled_run": "rotation_test",
          "busy_share_of_test_device_walls": [kernel_s / b["device_s"] for b in stats["batches"]],
          "busy_share_of_test_run_wall": kernel_s * len(stats["batches"]) / stats["wall_s"]})

    # kernels against the plain attention on batch 0
    from mobi_tpu_torch.pipeline import make_inpaint_pipeline

    attns = attention_targets(model.unet, "xla")
    saved = [m.attn_backend for m in attns]
    plain_run = make_inpaint_pipeline(model, **captured["kw"])
    for m in attns:
        m.attn_backend = "xla"
    _build.reset_launches()
    try:
        plain = plain_run(captured["batch"], torch.Generator(device=model.device).manual_seed(BENCH_SEED))
        torch.cuda.synchronize()
    finally:
        for m, was in zip(attns, saved):
            m.attn_backend = was
    if dict(_build.launches) != launch_counts():
        raise AssertionError(f"test_bench plain rerun launched {dict(_build.launches)}")

    def rel_l2(out):
        return {k: float((out[k].float() - plain[k].float()).norm() / plain[k].float().norm())
                for k in ("camera", "lidar")}

    rel = rel_l2(captured["out"])
    emit({"phase": "test_bench_vs_plain", "batch": 0, "tolerance_rel_l2": UNET_REL_L2, "rel_l2": rel})
    if not all(math.isfinite(v) and v <= UNET_REL_L2 for v in rel.values()):
        raise AssertionError(f"test_bench: kernels vs plain attention rel L2 {rel} > {UNET_REL_L2}")

    # batch 0 through the bench with the K2 and K6 switches on
    switched = {}
    model.unet.set_fused_gn(True)
    fa.set_transposed_av(True)
    try:
        _, sw_counts, _ = recorded_run(switched, ["--outdir", str(root / "switches"), "--max_batches", "1"],
                                       "test, MOBI_FLASH_TRANSPOSED_AV=1 and MOBI_FUSED_GN=1")
    finally:
        model.unet.set_fused_gn(False)
        fa.set_transposed_av(False)
    n_tav = sum(d < fa.TAV_MAX_HEAD_DIM for *_, d in calls)
    want = launch_counts(flash_fwd=PLMS_EVALS * (len(calls) - n_tav), flash_fwd_tav=PLMS_EVALS * n_tav,
                         gn_silu=PLMS_EVALS * len(unet_norm_calls(model.config, 4 * BENCH_PAIRS)))
    if sw_counts != want:
        raise AssertionError(f"test_bench with the K2 and K6 switches: launches {sw_counts}, expected {want}")
    if not all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
               for x, y in zip(tensor_leaves(switched["batch"]), tensor_leaves(captured["batch"]))):
        raise AssertionError("test_bench with the switches: batch 0's inputs differ from the first run's")
    rel_sw = rel_l2(switched["out"])
    emit({"phase": "test_bench_switches_vs_plain", "batch": 0, "tolerance_rel_l2": UNET_REL_L2, "rel_l2": rel_sw,
          "launches": {k: v for k, v in sw_counts.items() if v}})
    if not all(math.isfinite(v) and v <= UNET_REL_L2 for v in rel_sw.values()):
        raise AssertionError(f"test_bench: K2 + K6 switches vs plain rel L2 {rel_sw} > {UNET_REL_L2}")

    # the loader's host cost a sample: PNG decodes, masks, crops, resizes
    node = dict(BENCH_CONFIG["data"]["params"]["test"])
    node["params"] = {**node["params"], **db, "return_original_image": True}
    dataset = instantiate_from_config(node)
    t0 = time.perf_counter()
    for i in range(BENCH_LOADER_SAMPLES):
        dataset[i]
    loader_s = (time.perf_counter() - t0) / BENCH_LOADER_SAMPLES
    emit({"phase": "test_bench_loader", "seconds_per_sample": loader_s, "samples": BENCH_LOADER_SAMPLES,
          "frames": BENCH_IMG})
    batch0 = {k: v.float().cpu() for k, v in captured["out"].items()}
    captured.clear()
    switched.clear()
    torch.cuda.empty_cache()
    return {"batch0": batch0, "db": db,
            "launches_per_batch": {k: v / len(stats["batches"]) for k, v in counts.items() if v},
            "switches_launches_per_batch": {k: v for k, v in sw_counts.items() if v},
            "stats": stats, "rotation": rot, "rel_l2": rel, "loader_s": loader_s, "db_s": build_s}


def tensor_leaves(tree):
    """The leaves of a nested dict, in key order."""
    return [x for v in tree.values() for x in (tensor_leaves(v) if isinstance(v, dict) else [v])]


# The eval phase: the realism bench (mobi_tpu_torch/realism_test_bench.py)
# and its scorers at full width on the test_bench database, with seeded
# random weights in the published layouts (no published weights are in the
# repo; the scores they give are meaningless, the code paths are the real
# ones).
EVAL_STEPS = 10             # the shell's STEPS: PLMS-10 keeps the phase in its time
EVAL_PLMS_EVALS = EVAL_STEPS + 1
EVAL_SEED = 13
# Each network on the card against the CPU, fp32 with TF32 off: measured
# 7.4e-8 (LPIPS) to 1.47e-6 (CLIP); with TF32 on (the control) 7.6e-5
# (LPIPS) to 6.9e-4 (CLIP) (this script, NVIDIA H100 80GB HBM3 at 700 W).
# Gated between the two.
EVAL_REL_L2 = 1e-5
# (network, what it reads, CLI batch sizes timed): the JAX CLIs' batch
# sizes; fid_score's --batch-size (64) serves its Inception backbone too
EVAL_NETWORKS = (("clip_b32", "camera/object_ref", (64, 32)), ("inception", "camera/patch_gt", (64, 32)),
                 ("lpips", "camera/patch_gt", (32,)), ("rangenet", "lidar/range_orig", (16,)))

def eval_networks_card_vs_cpu(weights, mode_dir: Path, smi: str):
    """Gates 4 and 5 and the networks' rates: one batch of the files the run
    wrote (one range npy for RangeNet) through each network on the card (the
    one the realism run built, where it built it) and on the CPU with the
    same weights: relative L2 within EVAL_REL_L2, and a control on the card
    with TF32 on for matmuls and cuDNN convs that must land above it (the
    gate sees a TF32 leak); every parameter and output on the card; then
    each network at its CLI batch sizes (the batch tiled), items a second
    and the peak memory above what was resident."""
    import torch

    from mobi_tpu_torch.eval_tool import metric_scope, network, to_device
    from mobi_tpu_torch.eval_tool.camera import fid_score, lpips_score
    from mobi_tpu_torch.eval_tool.lidar import frd_score

    builds = {"clip_b32": (fid_score.clip_model, weights["clip"]),
              "inception": (fid_score.inception_model, weights["inception"]),
              "lpips": (lpips_score.lpips_model, weights["lpips"], weights["alexnet"]),
              "rangenet": (frd_score.rangenet_model, weights["rangenet_backbone"], weights["rangenet_decoder"])}

    def inputs(name, folder):
        if name == "rangenet":  # one file: the CPU's darknet53 at 64 x 1024 takes seconds a file
            return [frd_score.load_batch(frd_score.list_npys(mode_dir / folder)[:1])]
        files = fid_score.list_images(mode_dir / folder)
        if name == "clip_b32":
            return [fid_score.load_batch_clip(files)]
        if name == "inception":
            return [fid_score.load_batch_inception(files)]
        return [lpips_score.load_batch(files), lpips_score.load_batch(fid_score.list_images(mode_dir / "camera/patch_pred"))]

    rows = {}
    for name, folder, batch_sizes in EVAL_NETWORKS:
        build, *files = builds[name]
        host = inputs(name, folder)
        with metric_scope("cuda") as dev:
            net = network(build, *files, dev)
            xs = [to_device(x, dev) for x in host]
            card = net(*xs)
            on_card = (all(p.device.type == "cuda" for p in net.parameters())
                       and all(x.device.type == "cuda" for x in xs) and card.device.type == "cuda")
            card = card.float().cpu()
            rates = {}
            for bs in batch_sizes:
                big = [x.repeat((-(-bs // x.shape[0]),) + (1,) * (x.dim() - 1))[:bs] for x in xs]
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                net(*big)
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
                ms = cuda_ms(lambda: net(*big), iters=3, warmup=1)
                rates[str(bs)] = {"ms": ms, "items_per_s": bs / (ms / 1e3), "peak_above_resident_gib": peak}
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True  # metric_scope resets
            tf32 = net(*xs).float().cpu()
            del net, xs, big
            torch.cuda.empty_cache()
        with metric_scope("cpu") as cpu:
            ref = build(*files, cpu)(*[to_device(x, cpu) for x in host]).float()
        rel = float((card - ref).norm() / ref.norm())
        rows[name] = {"reads": folder, "batch": host[0].shape[0], "shape": list(ref.shape),
                      "item": "pair" if name == "lpips" else "image", "rel_l2": rel,
                      "max_abs": float((card - ref).abs().max()), "ref_max_abs": float(ref.abs().max()),
                      "tf32_control_rel_l2": float((tf32 - ref).norm() / ref.norm()),
                      "finite": bool(torch.isfinite(card).all()), "on_cuda": on_card, "cli_batches": rates}
    emit({"phase": "eval_networks", "tolerance_rel_l2": EVAL_REL_L2, "precision": "fp32, TF32 off",
          "networks": rows, "nvidia_smi": smi})
    for name, r in rows.items():
        if not (r["finite"] and math.isfinite(r["rel_l2"]) and r["rel_l2"] <= EVAL_REL_L2 < r["tf32_control_rel_l2"]):
            raise AssertionError(f"eval: {name} on the card against the CPU, relative L2 {r['rel_l2']} (TF32 on: "
                                 f"{r['tf32_control_rel_l2']}); the gate is {EVAL_REL_L2}")
        if not r["on_cuda"]:
            raise AssertionError(f"eval: {name}'s parameters, inputs or outputs are not all on the card")
    return rows


def phase_eval(model, db, smi: str):
    """The realism bench at full width: seeded weights in the published
    layouts under build/eval/weights, then realism_test_bench.main with this
    bf16 model (--ckpt ""), the four reference modes, PLMS-10 at CFG 5, one
    batch of 4 objects a mode on the test_bench database, the scorers in
    process with the weights from the environment; FRD on each mode's
    range_{orig,pred}; format_results on the table. Gates: every cell of the
    table and every FRD finite, the LaTeX row of 20 numbers and both
    averages printed, each mode's batch 11 x the UNet's flash calls of K1
    and the scorers none, and eval_networks_card_vs_cpu."""
    import contextlib
    import csv
    import io

    import torch

    from mobi_tpu_torch import format_results
    from mobi_tpu_torch import inference_test_bench as bench
    from mobi_tpu_torch import realism_test_bench as rtb
    from mobi_tpu_torch.eval.fabricate import write_published
    from mobi_tpu_torch.eval_tool import reuse_networks
    from mobi_tpu_torch.eval_tool.lidar import frd_score
    from mobi_tpu_torch.ops import _build

    try:
        import yaml  # noqa: F401
    except ImportError:
        raise AssertionError("eval: the realism bench's ref_mode= and use_lidar= overrides reach the dataset "
                             "through the YAML's interpolation, which needs PyYAML")
    t_phase = time.perf_counter()
    root = ROOT / "build" / "eval"
    shutil.rmtree(root, ignore_errors=True)
    weights = write_published(root / "weights", EVAL_SEED, device="cuda")
    weights_s = time.perf_counter() - t_phase
    emit({"phase": "eval_weights", "seconds": weights_s,
          "bytes": {k: os.path.getsize(p) for k, p in weights.items()}})

    # one network of each kind for the four modes, FRD and gate 4
    with reuse_networks():
        per_mode = {}
        run_bench = bench.main

        def counted(argv, model=None):
            before = dict(_build.launches)
            stats = run_bench(argv, model=model)
            torch.cuda.synchronize()
            mode = next(a for a in argv if a.startswith("ref_mode=")).split("=", 1)[1]
            per_mode[mode] = {"launches": {k: v - before.get(k, 0) for k, v in _build.launches.items()},
                              "objects": stats["objects"], "wall_s": stats["wall_s"],
                              "device_s": [b["device_s"] for b in stats["batches"]]}
            return stats

        env = {"CLIP_B32_WEIGHTS": weights["clip"], "LPIPS_WEIGHTS": weights["lpips"],
               "ALEXNET_WEIGHTS": weights["alexnet"]}
        saved_env = {k: os.environ.get(k) for k in env}
        overrides = " ".join(f"data.params.test.params.{k}={v}" for k, v in db.items())
        argv = ["--ckpt", "", "--config", str(ROOT / "configs" / "mobi_nusc_512.yaml"), "--out", str(root / "realism"),
                "--steps", str(EVAL_STEPS), "--max_batches", "1", "--extra_overrides", overrides]
        os.environ.update(env)
        bench.main = counted
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            rtb.main(argv, model=model)
            torch.cuda.synchronize()
        finally:
            bench.main = run_bench
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        realism_s = time.perf_counter() - t0
        total = dict(_build.launches)
        table = root / "realism" / "realism_table.csv"
        with open(table, newline="") as f:
            rows = list(csv.reader(f))

        def number(s):
            try:
                return float(s)
            except ValueError:
                return float("nan")

        cells = [number(c) for r in rows[1:] for c in r[2:]]
        calls = len(unet_flash_calls(model.config, 4 * BENCH_PAIRS))
        want = launch_counts(flash_fwd=EVAL_PLMS_EVALS * calls)
        bench_sum = {k: sum(m["launches"].get(k, 0) for m in per_mode.values()) for k in total}
        scorer_launches = {k: v - bench_sum.get(k, 0) for k, v in total.items() if v - bench_sum.get(k, 0)}

        t0 = time.perf_counter()
        frd = {}
        for mode in rtb.MODES:
            d = root / "realism" / mode / "lidar"
            frd[mode] = frd_score.main(["--path_orig", str(d / "range_orig"), "--path_pred", str(d / "range_pred"),
                                        "--backbone-weights", weights["rangenet_backbone"],
                                        "--decoder-weights", weights["rangenet_decoder"]])
        frd_s = time.perf_counter() - t0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            format_results.main(str(table))
        printed = out.getvalue().splitlines()
        latex = next((line[len("latex row: "):].split(" & ") for line in printed if line.startswith("latex row: ")), [])
        emit({"phase": "eval_realism", "modes": list(per_mode), "table": rows, "frd": frd,
              "format_results": printed, "launches_per_mode": {m: {k: v for k, v in r["launches"].items() if v}
                                                                 for m, r in per_mode.items()},
              "scorer_launches": scorer_launches, "objects_per_mode": {m: r["objects"] for m, r in per_mode.items()},
              "bench_wall_s": {m: r["wall_s"] for m, r in per_mode.items()},
              "bench_device_s": {m: r["device_s"] for m, r in per_mode.items()},
              "realism_s": realism_s, "frd_s": frd_s, "steps": EVAL_STEPS, "nvidia_smi": smi})
        if (rows[0] != rtb.HEADER.split(",") or [r[1] for r in rows[1:]] != list(rtb.MODES) or len(cells) != 20
                or not all(math.isfinite(c) for c in cells)):
            raise AssertionError(f"eval: realism_table.csv {rows}")
        if not all(math.isfinite(v) for v in frd.values()) or len(frd) != 4:
            raise AssertionError(f"eval: FRD {frd}")
        if (len(latex) != 20 or not all(math.isfinite(number(v)) for v in latex)
                or not any(line.startswith("reinsertion avg: {") for line in printed)
                or not any(line.startswith("replacement avg: {") for line in printed)):
            raise AssertionError(f"eval: format_results printed {printed}")
        bad = {m: r for m, r in per_mode.items()
               if {k: v for k, v in r["launches"].items() if v} != {k: v for k, v in want.items() if v}
               or r["objects"] != BENCH_PAIRS}
        if bad or set(per_mode) != set(rtb.MODES) or scorer_launches:
            raise AssertionError(f"eval: launches {bad} (want {want} a mode), the scorers' {scorer_launches}")

        networks = eval_networks_card_vs_cpu(weights, root / "realism" / "id-ref", smi)
    seconds = time.perf_counter() - t_phase
    k1_per_mode = {m: r["launches"].get("flash_fwd", 0) for m, r in per_mode.items()}
    emit({"phase": "eval", "seconds": seconds, "weights_s": weights_s, "realism_s": realism_s, "frd_s": frd_s,
          "k1_launches_per_mode": k1_per_mode, "nvidia_smi": smi})
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": total, "launches_per_mode": k1_per_mode, "seconds": seconds, "networks": networks}


def phase_train(cfg, smi: str):
    """The adapter training step at full width, through the port's entry
    points (training.create_train_state, make_train_step), counted, timed
    and checked: finite losses, grad_norm > 0, every trainable tensor
    changed and every frozen one bitwise unchanged."""
    import torch

    from mobi_tpu_torch import training as T
    from mobi_tpu_torch.models.diffusion import MobiDiffusion
    from mobi_tpu_torch.ops import _build

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MobiDiffusion(cfg, device="cuda", seed=SEED, for_training=True)
    state, tx = T.create_train_state(model, schedule=T.lambda_linear_schedule(TRAIN_LR, TRAIN_WARMUP))
    train_step = T.make_train_step(model, tx)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch = make_batch(TRAIN_PAIRS)
    gen = torch.Generator(device=model.device).manual_seed(SEED + 2)
    mask = model.trainable_mask()
    before = {name: p.detach().clone() for name, p in model.named_parameters()}
    unet_batch = 2 * TRAIN_PAIRS
    n_grad = len(train_flash_calls(cfg, unet_batch))
    want = launch_counts(flash_fwd=len(unet_flash_calls(cfg, unet_batch)) - n_grad,
                         flash_fwd_lse=n_grad, flash_bwd_dq=n_grad, flash_bwd_dkv=n_grad)
    steps = []

    def run(label, **inject):
        _build.reset_launches()
        _, metrics = train_step(state, batch, gen, **inject)
        torch.cuda.synchronize()
        row = {k: float(v) for k, v in metrics.items()}
        row["step"], row["launches"] = label, dict(_build.launches)
        steps.append(row)
        return row

    # the counted step keeps the conditioning; the first timed one drops it
    # (CFG dropout, u_cond_percent 0.2 of the steps), so bbox_uncond_vector
    # gets a gradient within the phase; the others draw as training does
    counted = run("counted", drop=False)
    if counted["launches"] != want:
        raise AssertionError(f"train step launches {counted['launches']}, expected {want}")
    walls = []
    for i in range(TRAIN_TIMED_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(f"timed_{i}", drop=True if i == 0 else None)
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end) / 1e3)
    # device time by kernel class of one more step, CUDA activity only
    classes, top = profile_classes(lambda: run("profiled", drop=False))
    # bf16 K1 and K3 are one kernel (flash_fwd_sm90.cu): the profiled step
    # runs it for all of them, and no mma.sync forward
    fwd_kernels = {name: sum(c for _, c, key in top if name in key)
                   for name in ("flash_fwd_sm90_kernel<", "flash_fwd_kernel<")}
    if fwd_kernels != {"flash_fwd_sm90_kernel<": want["flash_fwd"] + want["flash_fwd_lse"],
                       "flash_fwd_kernel<": 0}:
        raise AssertionError(f"the profiled bf16 step ran the forward kernels {fwd_kernels}")
    model.unet.set_fused_gn(True)
    fused = run("fused_gn", drop=False)
    model.unet.set_fused_gn(False)
    want_fused = dict(want, gn_silu=len(unet_norm_calls(cfg, unet_batch)))
    if fused["launches"] != want_fused:
        raise AssertionError(f"fused train step launches {fused['launches']}, expected {want_fused}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for row in steps:
        if not all(math.isfinite(row[k]) for k in ("loss", "loss_camera", "loss_lidar")) \
                or not row["grad_norm"] > 0:
            raise AssertionError(f"train step {row['step']}: {row}")
    unchanged = [n for n, p in model.named_parameters() if mask[n] and torch.equal(p, before[n])]
    moved = [n for n, p in model.named_parameters() if not mask[n] and not torch.equal(p, before[n])]
    if unchanged or moved:
        raise AssertionError(f"trainable unchanged {unchanged[:5]} ({len(unchanged)}), "
                             f"frozen changed {moved[:5]} ({len(moved)})")
    del before

    # the launches of one whole-UNet backward: every flash call carries a gradient
    previous = os.environ.get("MOBI_TRAIN_UNET_FULL")
    os.environ["MOBI_TRAIN_UNET_FULL"] = "1"
    try:
        full = model.trainable_mask()
    finally:
        if previous is None:
            del os.environ["MOBI_TRAIN_UNET_FULL"]
        else:
            os.environ["MOBI_TRAIN_UNET_FULL"] = previous
    for name, p in model.named_parameters():
        p.requires_grad_(full[name])
    _build.reset_launches()
    loss, _ = model.training_loss(batch, gen, drop=False)
    loss.backward()
    torch.cuda.synchronize()
    full_counts = dict(_build.launches)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        p.grad = None
    n_all = len(unet_flash_calls(cfg, unet_batch))
    want_full = launch_counts(flash_fwd_lse=n_all, flash_bwd_dq=n_all, flash_bwd_dkv=n_all)
    if full_counts != want_full:
        raise AssertionError(f"whole-UNet backward launches {full_counts}, expected {want_full}")

    med = statistics.median(walls)
    busy = sum(classes.values())
    emit({"phase": "train_profile", "device_busy_s_per_step": busy,
          "busy_share_of_median_step": busy / med,
          "device_s_by_class": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
          "forward_kernel_launches": fwd_kernels, "top_kernels_s_count": top[:12]})
    emit({"phase": "train", "pairs": TRAIN_PAIRS, "unet_batch": unet_batch,
          "lr_schedule": f"lambda_linear_schedule({TRAIN_LR}, {TRAIN_WARMUP})",
          "trainable_params": sum(p.numel() for n, p in model.named_parameters() if mask[n]),
          "parameters": sum(p.numel() for p in model.parameters()), "build_s": build_s,
          "steps": steps, "step_s": walls, "median_step_s": med,
          "pairs_per_s": TRAIN_PAIRS / med, "peak_mem_gib": peak,
          "launches_per_step": counted["launches"], "launches_fused_gn_step": fused["launches"],
          "launches_whole_unet_backward": full_counts, "card": smi})
    return model, tx, counted["launches"]


def trainable_grads_vs_plain(model, tx, pairs: int, variants, tol: float, phase: str):
    """The trainable gradients of one full-width training loss at `pairs`
    pair(s), fixed t, noise and drop, through each variant (label, fused
    GroupNorm + SiLU, attention backend, MOBI_FLASH_BWD) against the same
    through the plain versions (every attention by the plain formula under
    autograd, GroupNorm then SiLU): relative L2 within `tol`, and the
    launches each variant must make."""
    import torch

    from mobi_tpu_torch.models.unet import CrossAttention
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.ops import flash_attention as fa

    cfg, unet = model.config, model.unet
    b, s = 2 * pairs, cfg.latent_size
    g = torch.Generator(device=model.device).manual_seed(SEED + 3)
    t = torch.randint(0, cfg.timesteps, (b,), generator=g, device=model.device)
    noise = torch.randn(b, s, s, 4, generator=g, device=model.device).to(cfg.dtype)
    batch = make_batch(pairs)
    attns = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    saved = [m.attn_backend for m in attns]

    def grads(fused: bool, backend: str, bwd_mode: str):
        unet.set_fused_gn(fused)
        for m in attention_targets(unet, backend):
            m.attn_backend = backend
        fa.BWD_MODE = bwd_mode
        g.manual_seed(SEED + 4)  # the same posterior draws in every variant
        tx.zero_grad()
        _build.reset_launches()
        try:
            loss, _ = model.training_loss(batch, g, t=t, noise=noise, drop=False)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            unet.set_fused_gn(False)
            for m, was in zip(attns, saved):
                m.attn_backend = was
            fa.BWD_MODE = "pallas"
        flat = torch.cat([p.grad.float().flatten() for p in tx.params])
        tx.zero_grad()
        return flat, loss.item(), dict(_build.launches)

    ref, ref_loss, n_ref = grads(False, "xla", "pallas")
    results = {"plain": dict(n_ref, loss=ref_loss)}
    for label, fused, backend, mode in variants:
        got, loss, n = grads(fused, backend, mode)
        rel = float((got - ref).norm() / ref.norm())
        results[label] = dict(n, loss=loss, rel_l2_vs_plain=rel)
        if not bool(torch.isfinite(got).all()) or rel > tol:
            raise AssertionError(f"{phase} trainable gradients {label}: rel L2 {rel} vs the plain versions")
        del got
    n_calls, n_grad = len(unet_flash_calls(cfg, b)), len(train_flash_calls(cfg, b))
    n_all = len(train_flash_calls(cfg, b, "flash"))
    zero = launch_counts()
    kernels = dict(zero, flash_fwd=n_calls - n_grad, flash_fwd_lse=n_grad, flash_bwd_dq=n_grad,
                   flash_bwd_dkv=n_grad)
    want = {"plain": zero, "kernels": kernels,
            "kernels_fused_gn": dict(kernels, gn_silu=len(unet_norm_calls(cfg, b))),
            "flash_bwd_xla": dict(zero, flash_fwd=n_calls),
            "flash_all": dict(zero, flash_fwd=1, flash_fwd_lse=n_all, flash_bwd_dq=n_all, flash_bwd_dkv=n_all)}
    for label in results:
        got = {k: results[label][k] for k in want[label]}
        if got != want[label]:
            raise AssertionError(f"{phase} {label} launches {got}, expected {want[label]}")
    emit({"phase": phase, "dtype": str(cfg.dtype).replace("torch.", ""), "pairs": pairs, "t": t.tolist(),
          "trainable_grad_elements": int(ref.numel()), "tolerance_rel_l2": tol, **results})
    return results


def phase_train_switches(model, tx):
    """bf16: the kernels (K1, K3-K5), with the fused norm (K6), the
    MOBI_FLASH_BWD=xla backward, and attn_backend "flash" (K3-K5 at every
    level, d = 160 included), each against the plain versions."""
    return trainable_grads_vs_plain(model, tx, SWITCH_PAIRS, (
        ("kernels", False, "auto", "pallas"), ("kernels_fused_gn", True, "auto", "pallas"),
        ("flash_bwd_xla", False, "auto", "xla"), ("flash_all", False, "flash", "pallas")),
        GRAD_REL_L2, "train_switches")


REMAT_REL_L2 = 1e-3  # remat'd trainable gradients against the same step without remat
REMAT_PAIRS = TRAIN_PAIRS


def phase_remat(model, tx):
    """One training loss and its backward at full width, 2 pairs, on the
    same batch with t, noise and the CFG drop injected, three ways: the
    UNet's use_checkpoint False, "transformer" and True (torch.utils
    .checkpoint; the recomputed forward runs K3 again in every remat'd
    transformer). Peak memory above what the model holds, device time (CUDA
    events) and the flash launches of each; the trainable gradients of each
    remat run within REMAT_REL_L2 (relative L2) of the run without."""
    import torch

    from mobi_tpu_torch.ops import _build

    cfg, unet = model.config, model.unet
    b, s = 2 * REMAT_PAIRS, cfg.latent_size
    g = torch.Generator(device=model.device).manual_seed(SEED + 5)
    t = torch.randint(0, cfg.timesteps, (b,), generator=g, device=model.device)
    noise = torch.randn(b, s, s, 4, generator=g, device=model.device).to(cfg.dtype)
    batch = make_batch(REMAT_PAIRS)
    rows, ref = {}, None
    for mode in ("warm-up", False, "transformer", True):
        unet.use_checkpoint = False if mode == "warm-up" else mode
        g.manual_seed(SEED + 6)  # the same posterior draws every time
        tx.zero_grad()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        try:
            start.record()
            loss, _ = model.training_loss(batch, g, t=t, noise=noise, drop=False)
            loss.backward()
            end.record()
            torch.cuda.synchronize()
        finally:
            unet.use_checkpoint = False
        flat = torch.cat([p.grad.float().flatten() for p in tx.params])
        tx.zero_grad()
        if mode == "warm-up":  # the first backward's allocations and cuDNN's plans, untimed
            continue
        row = {"loss": loss.item(), "device_ms": start.elapsed_time(end),
               "peak_above_model_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
               "launches": dict(_build.launches)}
        if ref is None:
            ref = flat
        else:
            row["rel_l2_vs_no_remat"] = float((flat - ref).norm() / ref.norm())
            if not bool(torch.isfinite(flat).all()) or row["rel_l2_vs_no_remat"] > REMAT_REL_L2:
                raise AssertionError(f"remat {mode!r}: trainable gradients rel L2 {row['rel_l2_vs_no_remat']}")
        rows[str(mode)] = row
        del flat
    n_grad = len(train_flash_calls(cfg, b))
    for mode, row in rows.items():
        n = row["launches"]
        if not (n["flash_fwd_lse"] >= n_grad and n["flash_bwd_dq"] == n["flash_bwd_dkv"] == n_grad):
            raise AssertionError(f"remat {mode}: launches {n}, expected K4 = K5 = {n_grad}, K3 >= {n_grad}")
    if rows["False"]["launches"]["flash_fwd_lse"] != n_grad:
        raise AssertionError(f"no remat: K3 launched {rows['False']['launches']['flash_fwd_lse']}, not {n_grad}")
    peaks = [rows[m]["peak_above_model_gib"] for m in ("False", "transformer", "True")]
    emit({"phase": "remat", "pairs": REMAT_PAIRS, "unet_batch": b, "t": t.tolist(), "tolerance_rel_l2": REMAT_REL_L2,
          "trainable_grad_elements": int(ref.numel()), "peaks_fall_in_order": peaks[0] > peaks[1] > peaks[2],
          **rows})
    return rows


CLI_STEPS, CLI_RESUME_STEPS = 16, 18
CLI_ARGS = ["--log_every", "2", "--val_every", "8", "--save_every", "8", "--image_log_every", "8",
            "--image_log_steps", "20", "--image_log_max", "2", "--save_top_k", "2"]
CLI_IMAGE_STEMS = ("cam0", "cam1", "range_depth0", "range_depth1", "range_intensity0", "range_intensity1")


def trace_busy(trace_dir: str):
    """(kernel seconds, seconds covered by at least one kernel, the span
    from the first kernel's start to the last's end) of the torch.profiler
    trace file in `trace_dir`."""
    files = sorted(Path(trace_dir).glob("*.json"))
    if not files:
        raise AssertionError(f"no profiler trace in {trace_dir}")
    events = json.loads(files[-1].read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel" and "dur" in e)
    if not spans:
        raise AssertionError("the profiler trace holds no kernel")
    covered, end = 0.0, -math.inf
    for a, z in spans:
        if z > end:
            covered += z - max(a, end)
            end = z
    return sum(z - a for a, z in spans) / 1e6, covered / 1e6, (spans[-1][1] - spans[0][0]) / 1e6


def expected_retention(phases, max_to_keep: int, monitor: str):
    """The steps the port's CheckpointManager keeps under `phases` of saves
    ([(step, metrics or None)] a run), by its retention rule
    (checkpoint._preserved, held step for step against orbax by
    tests/test_torch_checkpoint.py), a raising ranking keeping everything."""
    from mobi_tpu_torch.checkpoint import _preserved

    infos = []
    for phase in phases:
        for step, metrics in phase:
            if infos and infos[-1][0] >= step:
                continue
            infos.append((step, metrics or {}))
            try:
                keep = _preserved(infos, max_to_keep, (lambda m: m[monitor]) if monitor else None)
            except KeyError:
                continue
            infos = [i for i, k in zip(infos, keep) if k]
    return [s for s, _ in infos]


def phase_train_cli(smi: str):
    """The training CLI (python -m mobi_tpu_torch.train, its main in
    process) at the full width of configs/mobi_nusc_512.yaml (bf16, batch_size
    2: UNet batch 4), seeded weights with the zero-init knob, use_ema, the
    reference's scheduler class, on a synthetic database at 1600 x 900:
    CLI_STEPS steps with validation, saves and collages every 8 and a
    profiler trace of steps 10-15, then --resume to CLI_RESUME_STEPS.
    Gated: every logged loss finite, metrics.jsonl with every logged step,
    the collages, the retained checkpoints of the manager's rule, the
    restored model, optimizer and EMA shadow bit for bit equal to the saved
    ones at step CLI_STEPS, and convert.load_checkpoint of the directory
    equal to the last checkpoint. Reports step walls, the traced steps'
    busy share, peak memory, the preflight, the losses, checkpoint bytes and
    save seconds, and K1, K3-K5 launches per training step, validation
    batch and image-log call, each counted alone."""
    import shutil
    import tempfile

    import torch

    from mobi_tpu_torch import checkpoint as C
    from mobi_tpu_torch import convert
    from mobi_tpu_torch import train as T
    from mobi_tpu_torch.data.synthetic import build_synthetic_database
    from mobi_tpu_torch.models.diffusion import MobiDiffusion
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.utils.config import load_config, mobi_config_from_yaml

    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="train_cli_", dir=ROOT / "build"))
    yaml_path = str(ROOT / "configs" / "mobi_nusc_512.yaml")
    db = build_synthetic_database(str(root / "db"), img_w=BENCH_IMG[0], img_h=BENCH_IMG[1], seed=SEED)
    overrides = ["model.params.scheduler_config.target=ldm.lr_scheduler.LambdaLinearScheduler",
                 "model.params.use_ema=True"] + [f"data.params.{split}.params.{k}={v}"
                                                 for split in ("train", "validation") for k, v in db.items()]
    parts = {"train_step": [], "validate": [], "image_log": []}
    saves = []

    def counted(name, fn):
        def wrapped(*a, **k):
            before = dict(_build.launches)
            out = fn(*a, **k)
            parts[name].append({key: n - before.get(key, 0) for key, n in _build.launches.items()
                                if n - before.get(key, 0)})
            return out
        return wrapped

    def timed_save(self, step, state, metrics=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return save(self, step, state, metrics)
        finally:
            saves.append({"step": step, "seconds": time.perf_counter() - t0, "metrics": bool(metrics)})

    restored = {}

    def spying_restore(self, step=None, state=None):
        out = restore(self, step, state)
        # copies: the optimizer's step counts live on the host, and the steps
        # after the restore move them in place
        def snap(v):
            return v.detach().to("cpu", copy=True)

        restored.update(step=state.step, model={k: snap(v) for k, v in state.model.state_dict().items()},
                        inner={i: {k: snap(v) for k, v in st.items()}
                               for i, st in state.opt.inner.state_dict()["state"].items()},
                        counts=(state.opt.count, state.opt.mini_step),
                        ema={k: snap(v) for k, v in state.ema.shadow.items()}, updates=state.ema.num_updates)
        return out

    make_step, validate, maybe_log = T.make_train_step, T.validate, T.ImageLogger.maybe_log
    save, restore = C.CheckpointManager.save, C.CheckpointManager.restore
    T.make_train_step = lambda model, tx, device=None, mesh=None: counted(
        "train_step", make_step(model, tx, device=device, mesh=mesh))
    T.validate = counted("validate", validate)
    T.ImageLogger.maybe_log = counted("image_log", maybe_log)
    C.CheckpointManager.save, C.CheckpointManager.restore = timed_save, spying_restore
    zero_init = os.environ.get("MOBI_RANDOMIZE_ZERO_INIT")
    os.environ["MOBI_RANDOMIZE_ZERO_INIT"] = "1"
    try:
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        stats = T.main(["--base", yaml_path, "--logdir", str(root / "logs"), "--max_steps", str(CLI_STEPS),
                        "--seed", str(SEED), "--profile-dir", str(root / "profile")] + CLI_ARGS + overrides)
        run_s = time.perf_counter() - t0
        launches = dict(_build.launches)
        first = {k: list(v) for k, v in parts.items()}
        logdir, ckpt_dir = stats["logdir"], stats["ckpt_dir"]
        kept_first = C.CheckpointManager(ckpt_dir).all_steps()
        saved = C.read_step(os.path.join(ckpt_dir, str(CLI_STEPS)))
        for v in parts.values():
            v.clear()
        _build.reset_launches()
        t0 = time.perf_counter()
        stats2 = T.main(["--resume", logdir, "--max_steps", str(CLI_RESUME_STEPS), "--seed", str(SEED)] + CLI_ARGS)
        resume_s = time.perf_counter() - t0
        resume_launches = dict(_build.launches)
    finally:
        T.make_train_step, T.validate, T.ImageLogger.maybe_log = make_step, validate, maybe_log
        C.CheckpointManager.save, C.CheckpointManager.restore = save, restore
        if zero_init is None:
            del os.environ["MOBI_RANDOMIZE_ZERO_INIT"]
        else:
            os.environ["MOBI_RANDOMIZE_ZERO_INIT"] = zero_init
    torch.cuda.empty_cache()

    # the restored state: bit for bit the checkpoint of step CLI_STEPS
    mismatched = [k for k, v in saved["model"].items()
                  if restored["model"][k].dtype != v.dtype or not torch.equal(restored["model"][k], v)]
    mismatched += [f"ema.{k}" for k, v in saved["ema"]["shadow"].items() if not torch.equal(restored["ema"][k], v)]
    mismatched += [f"opt.{i}.{k}" for i, st in saved["optimizer"]["inner"]["state"].items() for k, v in st.items()
                   if not torch.equal(restored["inner"][i][k], v)]
    if mismatched or restored["step"] != CLI_STEPS or stats2["step"] != CLI_RESUME_STEPS \
            or restored["counts"] != (saved["optimizer"]["count"], saved["optimizer"]["mini_step"]) \
            or restored["updates"] != saved["ema"]["num_updates"]:
        raise AssertionError(f"resume: step {restored['step']} -> {stats2['step']}, mismatched {mismatched[:5]} "
                             f"({len(mismatched)})")
    n_checked = len(saved["model"]) + len(saved["ema"]["shadow"]) + sum(
        len(st) for st in saved["optimizer"]["inner"]["state"].values())
    del saved, restored

    # the records
    records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    train_recs = [r for r in records if "train/loss" in r]
    vals = [r for r in records if "val/loss_simple" in r]
    imagelog = [r for r in records if any(k.startswith("imagelog/") for k in r)]
    want_steps = list(range(2, CLI_RESUME_STEPS + 1, 2))
    if [r["train/step"] for r in train_recs] != want_steps or not all(
            math.isfinite(r[k]) for r in train_recs for k in ("train/loss", "train/loss_simple", "train/grad_norm")):
        raise AssertionError(f"train records: {[(r['train/step'], r['train/loss']) for r in train_recs]}")
    if [r["step"] for r in vals] != [8, 16] or not all(math.isfinite(r[k]) for r in vals
                                                       for k in ("val/loss_simple", "val/loss_simple_ema")):
        raise AssertionError(f"validation records: {vals}")
    if [r["step"] for r in imagelog] != [8, 16] or not all(
            math.isfinite(v) for r in imagelog for k, v in r.items() if k.startswith("imagelog/")):
        raise AssertionError(f"imagelog records: {imagelog}")
    images = set(os.listdir(os.path.join(logdir, "images")))
    missing = [f"step{s:08d}_{stem}.png" for s in (8, 16) for stem in CLI_IMAGE_STEMS
               if f"step{s:08d}_{stem}.png" not in images]
    if missing:
        raise AssertionError(f"collages missing: {missing}")
    mon = "val/loss_simple"
    runs = [[(r["step"], {mon: r[mon]}) for r in vals] + [(CLI_STEPS, None)], [(CLI_RESUME_STEPS, None)]]
    kept = C.CheckpointManager(ckpt_dir).all_steps()
    want_kept = expected_retention(runs, 2, mon)
    if kept != want_kept or kept_first != expected_retention(runs[:1], 2, mon):
        raise AssertionError(f"retained checkpoints {kept_first} then {kept}, the rule gives {want_kept}")
    ckpt_bytes = {s: sum(f.stat().st_size for f in Path(ckpt_dir, str(s)).iterdir()) for s in kept}

    # the bench's loader: the last checkpoint into a fresh model
    cfg = mobi_config_from_yaml(load_config([os.path.join(logdir, "configs", "merged.yaml")]))
    fresh = MobiDiffusion(cfg, device="cuda", seed=SEED + 1, for_training=True)
    info = convert.load_checkpoint(fresh, ckpt_dir)
    last = C.read_step(os.path.join(ckpt_dir, str(kept[-1])), parts=("model",))["model"]
    differ = [k for k, v in fresh.state_dict().items() if not torch.equal(v.cpu(), last[k])]
    if info["step"] != kept[-1] or info["missing"] or differ:
        raise AssertionError(f"load_checkpoint: step {info['step']}, missing {info['missing'][:3]}, differ {differ[:3]}")
    del fresh, last
    torch.cuda.empty_cache()

    kernel_s, busy_s, span_s = trace_busy(str(root / "profile"))
    prof_wall = stats["profile"]["wall_s"]
    files = sorted(str(p.relative_to(logdir)) for p in Path(logdir).rglob("*") if p.is_file())
    step_s = stats["step_s"]
    keys = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")

    def per(name, rows):
        return [{k: r.get(k, 0) for k in keys} for r in rows]

    n_val_batches = min(8, len(T.build_datasets(load_config([os.path.join(logdir, "configs", "merged.yaml")]),
                                                ("validation",))[0]["validation"]) // 2)
    out = {"phase": "train_cli", "steps": CLI_STEPS, "resumed_to": CLI_RESUME_STEPS, "pairs": 2,
           "run_s": run_s, "resume_s": resume_s, "median_step_s": statistics.median(step_s),
           "pairs_per_s": 2 / statistics.median(step_s), "step_s": step_s,
           "profiled_steps": [10, 15], "profile_wall_s": prof_wall, "profile_kernel_s": kernel_s,
           "profile_busy_s": busy_s, "busy_share": busy_s / prof_wall, "profile_kernel_span_s": span_s,
           "peak_mem_gib": [e.get("train/peak_device_mem_mb", 0) / 1024 for e in stats["epochs"]],
           "preflight": stats["preflight"],
           "val": vals, "imagelog": imagelog, "train_loss": [(r["train/step"], r["train/loss"]) for r in train_recs],
           "retained": kept, "checkpoint_bytes": ckpt_bytes, "saves": saves, "restored_tensors_checked": n_checked,
           "files": len(files), "files_sample": files[:8] + files[-8:],
           "launches_run": launches, "launches_resume": resume_launches,
           "launches_per_train_step": per("train_step", first["train_step"][:1])[0],
           "launches_per_val_batch": {k: v // n_val_batches for k, v in per("validate", first["validate"][:1])[0].items()},
           "val_batches": n_val_batches, "launches_per_image_log": per("image_log", first["image_log"][:1])[0],
           "card": smi}
    emit(out)
    # the last checkpoint stays for the range_vae phase's export, the rest goes
    final = ROOT / "build" / "train_cli_final"
    shutil.rmtree(final, ignore_errors=True)
    final.mkdir(parents=True)
    shutil.move(os.path.join(ckpt_dir, str(kept[-1])), str(final / str(kept[-1])))
    shutil.rmtree(root, ignore_errors=True)
    out["final_checkpoint"] = str(final / str(kept[-1]))
    return out


# The range_vae phase: python -m mobi_tpu_torch.train_autoencoder (its main in
# process) at the full width of configs/range_autoencoder.yaml (512 x 512 range
# views, 2 channels, ch 128 x (1, 2, 4, 4), 2 res blocks, the lidar adapter,
# batch 4, fp32, remat per block), seeded weights, on a synthetic database:
# RANGE_VAE_GATED_STEPS at the shipped disc_start (10000, the GAN terms gated
# off), then RANGE_VAE_OPEN_STEPS from the same seed with disc_start 0 (the
# adaptive weight and the discriminator step on). Both cut max_steps only.
RANGE_VAE_GATED_STEPS, RANGE_VAE_OPEN_STEPS = 2, 3


def phase_range_vae(smi: str, cli_final: str):
    """The range_vae phase (see RANGE_VAE_GATED_STEPS). Gated: every logged
    value finite; the GAN term's weight d_weight x disc_factor 0 on the
    gated steps and d_weight finite and > 0 on the open ones (the weight
    itself is computed on every step, as in the JAX package and the
    reference, and disc_factor gates it); the discriminator bitwise at its
    seeded start after the gated run and moved after the open one; every
    frozen VAE parameter bitwise at its seeded start and every adapter
    tensor moved, in both runs; extract_autoencoder of the open run's last
    checkpoint loaded strict into a fresh range VAE, bitwise; and
    export_checkpoint of the train_cli phase's final checkpoint (with its
    EMA) reloaded strict into a fresh model, bitwise, with its model_ema.*
    and schedule entries. Reports the step walls, the peak memory
    (utils/hbm.measure), the busy share of the open run's last two steps
    under torch.profiler, the kernels' launches (none on this path) and
    the export's bytes and seconds, then deletes what it wrote."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mobi_tpu_torch import checkpoint as C
    from mobi_tpu_torch import export_checkpoint as EX
    from mobi_tpu_torch import extract_autoencoder as EA
    from mobi_tpu_torch import train_autoencoder as TA
    from mobi_tpu_torch.data.synthetic import build_synthetic_database
    from mobi_tpu_torch.models.diffusion import MobiDiffusion
    from mobi_tpu_torch.models.vae import autoencoder_from_config
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.utils import hbm
    from mobi_tpu_torch.utils.config import load_config, mobi_config_from_yaml

    t_phase = time.perf_counter()
    root = ROOT / "build" / "range_vae"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    yaml_path = str(ROOT / "configs" / "range_autoencoder.yaml")
    cfg = load_config([yaml_path])
    mp = cfg["model"]["params"]
    db = build_synthetic_database(str(root / "db"), img_w=BENCH_IMG[0], img_h=BENCH_IMG[1], seed=SEED)
    overrides = [f"data.params.train.params.{k}={v}" for k, v in db.items()]

    prof, profiled = {}, {}
    call = TA.GanStep.__call__

    def profiled_call(self, x, step, noise=None):
        if prof.get("first") == step:
            torch.cuda.synchronize()
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()
        out = call(self, x, step, noise)
        if prof.get("last") == step:
            torch.cuda.synchronize()
            profiled.update(wall_s=time.perf_counter() - prof["t0"], p=prof["p"], steps=[prof["first"], step])
            prof["p"].__exit__(None, None, None)
        return out

    def run(name, steps, extra):
        argv = (["--base", yaml_path, "--logdir", str(root / name), "--max_steps", str(steps), "--log_every", "1",
                 "--seed", str(SEED)] + overrides + list(extra))
        _build.reset_launches()
        stats, record = hbm.measure(lambda: TA.main(argv))
        return stats, record, {k: v for k, v in _build.launches.items() if v}

    # the gated run's last step under the profiler (its wall is not one of
    # the reported ones: the open run's steps are timed unprofiled)
    TA.GanStep.__call__ = profiled_call
    prof.update(first=RANGE_VAE_GATED_STEPS - 1, last=RANGE_VAE_GATED_STEPS - 1)
    try:
        gated = run("gated", RANGE_VAE_GATED_STEPS, [])
        prof.clear()
        opened = run("open", RANGE_VAE_OPEN_STEPS, ["model.params.lossconfig.params.disc_start=0"])
    finally:
        TA.GanStep.__call__ = call
    (root / "profile").mkdir()
    profiled["p"].export_chrome_trace(str(root / "profile" / "trace.json"))
    kernel_s, busy_s, span_s = trace_busy(str(root / "profile"))

    # the starts: the seeded VAE and discriminator the CLI builds
    with torch.device("cuda"):
        start_vae = autoencoder_from_config(**mp).init_random_(SEED)
    start = {k: v.cpu() for k, v in start_vae.state_dict().items()}
    start_d = {k: v for k, v in TA.build_loss(mp["lossconfig"], mp["ddconfig"]["in_channels"], SEED)
               .state_dict().items() if k.startswith("discriminator.")}
    adapter = set(TA.trainable_names(start_vae))
    del start_vae
    runs, bad = {}, []
    for name, (stats, record, launches) in (("gated", gated), ("open", opened)):
        hist = stats["history"]
        saved = C.read_step(os.path.join(stats["ckpt_dir"], str(stats["step"])), parts=("vae", "loss"))
        frozen_moved = [k for k, v in saved["vae"].items() if k not in adapter and not torch.equal(v, start[k])]
        adapter_still = [k for k in adapter if torch.equal(saved["vae"][k], start[k])]
        d_moved = [k for k, v in start_d.items() if not torch.equal(saved["loss"][k], v)]
        open_run = name == "open"
        runs[name] = {"steps": stats["step"], "step_s": stats["step_s"],
                      "total_loss": [h["train/total_loss"] for h in hist],
                      "d_weight": [h["train/d_weight"] for h in hist],
                      "disc_factor": [h["train/disc_factor"] for h in hist],
                      "disc_loss": [h["train/disc_loss"] for h in hist],
                      "rec_loss": [h["train/rec_loss"] for h in hist],
                      "peak_mem_gib": (record.argument_size_in_bytes + record.output_size_in_bytes
                                       + record.temp_size_in_bytes) / 2**30,
                      "launches": launches, "frozen_moved": frozen_moved[:5], "adapter_unmoved": adapter_still[:5],
                      "discriminator_moved": len(d_moved), "discriminator_tensors": len(start_d)}
        if (not all(math.isfinite(v) for h in hist for v in h.values()) or len(hist) != stats["step"]
                or frozen_moved or adapter_still or launches
                or any(h["train/disc_factor"] != (1.0 if open_run else 0.0) for h in hist)
                or not all(h["train/d_weight"] > 0 if open_run else h["train/d_weight"] * h["train/disc_factor"] == 0
                           for h in hist)
                or (len(d_moved) != len(start_d) if open_run else d_moved)):
            bad.append(name)
        del saved

    # the chain: extract_autoencoder of the open run's last checkpoint
    out_vae = root / "vae.pt"
    t0 = time.perf_counter()
    EA.main(["--ckpt", opened[0]["ckpt_dir"], "--out", str(out_vae)])
    extract_s = time.perf_counter() - t0
    with torch.device("cuda"):
        fresh_vae = autoencoder_from_config(**mp)
    fresh_vae.load_state_dict(torch.load(out_vae), strict=True)
    want = C.read_step(os.path.join(opened[0]["ckpt_dir"], str(opened[0]["step"])), parts=("vae",))["vae"]
    chain_differ = [k for k, v in fresh_vae.state_dict().items() if not torch.equal(v.cpu(), want[k])]
    del fresh_vae, want

    # the export of the train_cli phase's final checkpoint
    out_ckpt = root / "exported.ckpt"
    t0 = time.perf_counter()
    EX.main(["--config", str(ROOT / "configs" / "mobi_nusc_512.yaml"), "--ckpt", cli_final, "--out", str(out_ckpt)])
    export_s = time.perf_counter() - t0
    export_bytes = out_ckpt.stat().st_size
    blob = torch.load(out_ckpt, map_location="cpu", weights_only=False)
    sd = blob["state_dict"]
    ema_keys = [k for k in sd if k.startswith("model_ema.")]
    sched_keys = [k for k in EX.SCHEDULE_BUFFERS if k in sd]
    saved = C.read_step(cli_final, parts=("model", "ema"))
    fresh = MobiDiffusion(mobi_config_from_yaml(load_config([str(ROOT / "configs" / "mobi_nusc_512.yaml")])),
                          device="cuda", seed=SEED + 2, for_training=True)
    fresh.load_state_dict({k: v for k, v in sd.items() if not k.startswith("model_ema.") and k not in sched_keys},
                          strict=True)
    export_differ = [k for k, v in fresh.state_dict().items()
                     if v.dtype != saved["model"][k].dtype or not torch.equal(v.cpu(), saved["model"][k])]
    ema_differ = [k for k, v in saved["ema"]["shadow"].items()
                  if not torch.equal(sd["model_ema." + ("diffusion_model." + k).replace(".", "")], v.float())]
    export = {"bytes": export_bytes, "seconds": export_s, "entries": len(sd), "model_ema_entries": len(ema_keys),
              "schedule_entries": len(sched_keys), "global_step": blob["global_step"],
              "model_tensors_checked": len(saved["model"]), "differ": export_differ[:5], "ema_differ": ema_differ[:5]}
    ema_n = len(saved["ema"]["shadow"])
    del blob, sd, saved, fresh
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)  # cli_final stays for the lifecycle child

    walls = runs["open"]["step_s"][-3:]
    line = {"phase": "range_vae", "config": "configs/range_autoencoder.yaml", "batch": 4, "range_view": [512, 512],
            "channels": 2, "ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2, "lidar_adapter": True,
            "precision": "fp32", "remat": True,
            "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32, "cudnn": torch.backends.cudnn.allow_tf32},
            "cuts": {"max_steps": [RANGE_VAE_GATED_STEPS, RANGE_VAE_OPEN_STEPS]}, "runs": runs,
            "median_step_s_last3": statistics.median(walls),
            "peak_mem_gib": max(r["peak_mem_gib"] for r in runs.values()),
            "profiled_steps": {"gated": profiled["steps"]}, "profile_wall_s": profiled["wall_s"],
            "profile_kernel_s": kernel_s, "profile_busy_s": busy_s, "profile_kernel_span_s": span_s,
            "busy_share": busy_s / profiled["wall_s"],
            "extract": {"seconds": extract_s, "differ": chain_differ[:5]}, "export": export,
            "phase_s": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    if (bad or chain_differ or export_differ or ema_differ or len(ema_keys) != ema_n + 2
            or len(sched_keys) != len(EX.SCHEDULE_BUFFERS)):
        raise AssertionError(f"range_vae: runs {bad}: {json.dumps(line)[:3000]}")
    return line


# ---------------------------------------------------------------- detection
DET_RUNS = (("lidar", False, 6), ("camera", True, 3))  # model, --use-camera, --max-samples
DET_PARAMS = {"lidar": 8_907_086, "camera": 39_817_694}  # float entries (the JAX drive's 8.9 M and 39.8 M)
# One sample, card against CPU, every pre-decode output, fp32 with TF32 off.
# What sets the reading under det_unit_state_dict's draws (on an H100: lidar
# 9.6e-6, camera ~5.5e-6): the decoder's cross attention, whose attn @ v is
# a GEMM over the 32,400 BEV keys that cuBLAS sums in fp32 2.4e-6 from fp64
# (the CPU's 1.3e-7), and the velocity head, a small-norm output, which
# amplifies the decoder's error ~7x (the CPU's own vel is 3.0e-6 from fp64).
# The convolutions do not set it: with cuDNN disabled the lidar reading is
# 9.4e-6. So the gate leaves the lidar reading ~4%, and a TF32 control
# misses it by 45x or more.
DET_REL_L2 = 1e-5
DET_DENSE_VOXELS = (60_000, 120_000)  # a real 10-sweep nuScenes cloud's range at the production grid
DET_DENSE_FORWARDS = 5


def det_unit_state_dict(model, seed: int):
    """Well-conditioned draws for the card-vs-CPU check: weights of two or
    more dims N(0, 1/fan_in), the position embeddings' first conv also
    divided by 100 (its inputs are BEV cells, 0 to 180), norm weights
    1 + N(0, 0.05), BN running variances 1 + |N(0, 0.05)|, the rest
    N(0, 0.05). Under the drive's draws the activations shrink until the
    heatmap is flat and top-k chooses among exact ties; with unscaled
    position embeddings the cross attention's logits reach ~1e4 and fp32
    alone lands ~1e-5 from fp64 (both measured on the CPU)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            out[k] = v.detach().cpu()
            continue
        a = torch.randn(v.shape, generator=g)
        if k.endswith("weight") and v.dim() >= 2:
            sparse = v.dim() == 5  # spconv's (*kernel, C_in, C_out)
            fan_in = v.numel() // (v.shape[-1] if sparse else v.shape[0])
            out[k] = a * fan_in ** -0.5 / (100.0 if "position_embedding_head.0." in k else 1.0)
        elif k.endswith("running_var"):
            out[k] = (a * 0.05).abs() + 1.0
        elif k.endswith("weight"):
            out[k] = 1.0 + 0.05 * a
        else:
            out[k] = 0.05 * a
    return out


def det_dense_cloud(seed: int = 0, ground: int = 70_000, walls: int = 20_000, sweeps: int = 10):
    """A fabricated 10-sweep cloud [N, 5] for the production grid: a ground
    disc to 54 m (points uniform in range, as lidar rings thin out) and 60
    vertical walls, intensity and the sweep's time lag; ~80k non-empty
    voxels, in a real 10-sweep nuScenes cloud's range."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r, th = rng.uniform(2.5, 54, ground), rng.uniform(-np.pi, np.pi, ground)
    parts = [np.stack([r * np.cos(th), r * np.sin(th), -1.8 + rng.normal(0, 0.05, ground)], 1)]
    for cx, cy in rng.uniform(-45, 45, (60, 2)):
        n, a, length = walls // 60, rng.uniform(0, 2 * np.pi), rng.uniform(3, 12)
        t = rng.uniform(-length / 2, length / 2, n)
        parts.append(np.stack([cx + t * np.cos(a), cy + t * np.sin(a), rng.uniform(-1.8, 2.5, n)], 1))
    pts = np.concatenate(parts)
    inten = rng.uniform(0, 255, (len(pts), 1))
    lag = rng.integers(0, sweeps, (len(pts), 1)) * 0.05
    return np.concatenate([pts, inten, lag], 1).astype(np.float32)


def detection_plan_child(out_path: str) -> int:
    """python3 chip_smoke.py --detection-plan OUT: the real-density cloud's
    host stage (hard voxelize, rulebook planning), timed, pickled to OUT;
    run beside scale_out, whose parent only waits."""
    import pickle

    sys.path.insert(0, str(ROOT))
    from mobi_tpu_torch import native
    from mobi_tpu_torch.models.bevfusion import _grid, plan_sparse_encoder

    vs, pcr = (0.075, 0.075, 0.2), (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
    pts = det_dense_cloud()
    native.build()
    t0 = time.perf_counter()
    voxels, coords, npv = native.hard_voxelize(pts, vs, pcr, max_points=10, max_voxels=120000)
    t1 = time.perf_counter()
    plans, out_coords, out_shape = plan_sparse_encoder(coords, _grid(vs, pcr))
    t2 = time.perf_counter()
    with open(out_path, "wb") as f:
        pickle.dump({"points": pts, "voxels": voxels, "npv": npv, "plans": plans, "out_coords": out_coords,
                     "out_shape": out_shape, "voxelize_s": t1 - t0, "plan_s": t2 - t1}, f, protocol=4)
    return 0


def det_compare(card_head, card, ref_head, ref):
    """Relative L2 of every pre-decode output of the card against the CPU's.
    The per-proposal outputs are matched by (class, cell), each side's
    proposals taken again by its own head on its own device (the forward's
    selection, bit for bit): values equal to rounding may rank differently
    on the two, and the decoder's outputs follow their proposals."""
    import torch

    _, cc, ci = card_head.proposals(card["dense_heatmap"])
    _, rc, ri = ref_head.proposals(ref["dense_heatmap"])
    card = {k: v.detach().cpu() for k, v in card.items()}
    card_keys = list(zip(cc[0].tolist(), ci[0].tolist()))
    ref_keys = list(zip(rc[0].tolist(), ri[0].tolist()))
    own = bool(torch.equal(cc.cpu(), card["query_labels"]))
    rels = {"dense_heatmap": float((card["dense_heatmap"] - ref["dense_heatmap"]).norm() / ref["dense_heatmap"].norm())}
    same = own and set(card_keys) == set(ref_keys)
    perm = [card_keys.index(k) for k in ref_keys] if same else None
    for k, v in ref.items():
        if k in ("dense_heatmap", "query_labels"):
            continue
        rels[k] = float((card[k][:, perm] - v).norm() / v.norm()) if same else math.inf
    return {"same_proposals": same, "reordered": same and perm != list(range(len(perm))), "rel_l2": rels,
            "max_rel_l2": max(rels.values())}


def det_attribution(sd, card_model, card_in, card, cpu_model, cpu_in, ref):
    """Where the lidar model's card-vs-CPU reading comes from: the card and
    the CPU each against a CPU fp64 forward, the decoder's cross attention
    alone on each fed the fp64 run's inputs, and the card's forward with
    cuDNN disabled against the CPU."""
    import torch

    from mobi_tpu_torch.detector_inference import build_detector

    m64 = build_detector(sd, False, device="cpu").double()
    got = {}
    hook = m64.heads["object"].decoder[0].multihead_attn.register_forward_hook(
        lambda m, a, o: got.update(args=a, out=o))
    with torch.no_grad():
        truth = m64(cpu_in[0].double(), *cpu_in[1:])
    hook.remove()

    def attention_alone(model):
        with torch.no_grad():
            out = model.heads["object"].decoder[0].multihead_attn(
                *(a.to(model.device, torch.float32) for a in got["args"]))
        return float((out.double().cpu() - got["out"]).norm() / got["out"].norm())

    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        with torch.no_grad():
            no_cudnn = card_model(*card_in)
    finally:
        torch.backends.cudnn.enabled = enabled
    h64 = m64.heads["object"]
    return {"card_vs_fp64": det_compare(card_model.heads["object"], card, h64, truth)["rel_l2"],
            "cpu_vs_fp64": det_compare(cpu_model.heads["object"], ref, h64, truth)["rel_l2"],
            "cross_attention_alone_vs_fp64": {"card": attention_alone(card_model), "cpu": attention_alone(cpu_model)},
            "card_cudnn_disabled_vs_cpu": det_compare(card_model.heads["object"], no_cudnn,
                                                      cpu_model.heads["object"], ref)["rel_l2"]}


def phase_detection(smi: str):
    """The detection phase before scale_out (see the module docstring);
    returns what phase_detection_dense needs and the phase's launches."""
    import contextlib
    import io

    import torch

    from mobi_tpu_torch import convert, detection_eval
    from mobi_tpu_torch.data import preprocess
    from mobi_tpu_torch.data.detection_dataset import DetectionSceneDataset
    from mobi_tpu_torch.data.synthetic import build_synthetic_nuscenes_raw
    from mobi_tpu_torch.detector_inference import build_detector, camera_inputs, load_checkpoint_state_dict
    from mobi_tpu_torch.eval.fabricate import det_drive_state_dict
    from mobi_tpu_torch.models.bevfusion import BEVFusionDetector, prepare_lidar_inputs
    from mobi_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    root = ROOT / "build" / "detection"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    raw = str(root / "raw")
    _build.reset_launches()
    t0 = time.perf_counter()
    build_synthetic_nuscenes_raw(raw, num_scenes=2, samples_per_scene=3)
    raw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        pre = preprocess.main(["--dataroot", raw, "--out-dir", str(root / "processed"), "--num-erase", "2",
                               "--write-infos"])
    pre_s = time.perf_counter() - t0
    with open(pre["object_database_path"]) as f:
        pre_rows = sum(1 for _ in f) - 1
    bad = [k for k, v in pre.items() if not Path(v).is_file()]

    runs = {}
    for name, use_camera, n in DET_RUNS:
        t0 = time.perf_counter()
        sd = det_drive_state_dict(BEVFusionDetector(use_camera=use_camera, device="cpu"), SEED)
        ckpt = convert.save_reference_checkpoint(sd, str(root / f"det_{name}.pth"))
        loaded = load_checkpoint_state_dict(ckpt)
        strict = BEVFusionDetector(use_camera=use_camera, device="cpu").load_state_dict(loaded, strict=True)
        params = sum(v.numel() for v in loaded.values() if v.is_floating_point())
        ckpt_s = time.perf_counter() - t0
        out = root / name
        argv = ["--dataroot", raw, "--results", str(out / "results.json"), "--out-dir", str(out),
                "--checkpoint", ckpt, "--sweeps-num", "2", "--max-samples", str(n), "--verbose-inference"]
        argv += ["--use-camera"] if use_camera else []
        timings = []
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            metrics = detection_eval.main(argv, timings=timings)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        with open(out / "results.json") as f:
            results = json.load(f)["results"]
        boxes = [b for dets in results.values() for b in dets]
        finite = all(math.isfinite(x) for b in boxes for x in b["translation"] + b["size"] + b["rotation"]
                     + b["velocity"] + [b["detection_score"]])
        runs[name] = {
            "checkpoint_mb": Path(ckpt).stat().st_size / 2**20, "checkpoint_s": ckpt_s, "parameters": params,
            "strict_load": {"missing": list(strict.missing_keys), "unexpected": list(strict.unexpected_keys)},
            "samples": len(results), "boxes": len(boxes), "finite": finite, "wall_s": wall,
            "metrics_summary": (out / "metrics_summary.json").is_file(), "mAP": metrics["mean_ap"],
            "NDS": metrics["nd_score"], "voxels": [t["voxels"] for t in timings],
            "host_s_per_sample": [t["host_s"] for t in timings], "wait_s": [t["wait_s"] for t in timings],
            "forward_s_per_sample": [t["forward_s"] for t in timings], "peak_above_resident_gib": peak,
            "log_tail": log.getvalue().splitlines()[-3:]}
        if (strict.missing_keys or strict.unexpected_keys or params != DET_PARAMS[name] or len(results) != n
                or not finite or not runs[name]["metrics_summary"] or not 0 <= metrics["nd_score"] <= 1):
            bad.append(name)
    launches = dict(_build.launches)

    # one sample of each model, card against CPU, well-conditioned weights;
    # sample 0 planned once (the two models share its lidar inputs)
    cross, models = {}, {}
    ex = DetectionSceneDataset(raw, sweeps_num=2, image_size=(256, 704))[0]
    grid = dict(voxel_size=(0.075, 0.075, 0.2), pc_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0))
    t0 = time.perf_counter()
    lidar_in = prepare_lidar_inputs(ex["points"], device="cpu", **grid)
    plan_s = time.perf_counter() - t0
    for name, use_camera, _ in DET_RUNS:
        sd = det_unit_state_dict(BEVFusionDetector(use_camera=use_camera, device="cpu"), SEED + 1)
        cpu_model = build_detector(sd, use_camera, device="cpu")
        card_model = build_detector(sd, use_camera, device="cuda")
        cpu_in = lidar_in
        card_in = (lidar_in[0].cuda(),) + lidar_in[1:]  # the plans copy their pairs to the card at first use
        cpu_kw = camera_inputs(cpu_model, ex) if use_camera else {}
        card_kw = {k: v.cuda() for k, v in cpu_kw.items()}
        with torch.no_grad():
            card = card_model(*card_in, **card_kw)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                tf32 = card_model(*card_in, **card_kw)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            t0 = time.perf_counter()
            ref = cpu_model(*cpu_in, **cpu_kw)
            cpu_s = time.perf_counter() - t0
        heads = (card_model.heads["object"], cpu_model.heads["object"])
        with torch.no_grad():
            row = det_compare(heads[0], card, heads[1], ref)
            row["tf32_control"] = det_compare(heads[0], tf32, heads[1], ref)
        row.update(voxels=int(card_in[0].shape[0]), host_plan_s=plan_s, cpu_forward_s=cpu_s,
                   on_cuda=all(p.device.type == "cuda" for p in card_model.parameters())
                   and all(v.device.type == "cuda" for v in card.values()),
                   finite=all(bool(torch.isfinite(v.float()).all()) for v in card.values()))
        if not use_camera:
            row["attribution"] = det_attribution(sd, card_model, card_in, card, cpu_model, cpu_in, ref)
        cross[name] = row
        models[name] = (card_model, ex)
        del cpu_model
        if not (row["on_cuda"] and row["finite"] and row["max_rel_l2"] <= DET_REL_L2
                < row["tf32_control"]["max_rel_l2"]):
            bad.append(f"{name}_card_vs_cpu")
    line = {"phase": "detection", "raw_s": raw_s, "preprocess_s": pre_s, "preprocess_rows": pre_rows,
            "preprocess_outputs": sorted(pre), "runs": runs, "launches": launches,
            "card_vs_cpu": {"tolerance_rel_l2": DET_REL_L2, "precision": "fp32, TF32 off", **cross},
            "phase_s": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    if bad or any(launches.values()):
        raise AssertionError(f"detection: {bad}, launches {launches}: {json.dumps(line)[:4000]}")
    return {"models": models, "launches": launches, "raw": raw, "ex": ex, "lidar_in": lidar_in}


# ----------------------------------------------------------- detector training
# One step of the lidar detector at the production grid, card against CPU,
# fp32 with TF32 off, on the detection phase's comparison sample and
# det_unit_state_dict's weights: the matching equal, the loss within
# DET_TRAIN_LOSS_RTOL, every trained tensor's gradient (BatchNorm's
# statistics included) within DET_TRAIN_GRAD_REL_L2 overall; the same step
# with TF32 on must miss one of the two.
DET_TRAIN_LOSS_RTOL = 1e-5
DET_TRAIN_GRAD_REL_L2 = 1e-4
DET_TRAIN_TIMED_STEPS = 3
DET_TRAIN_MAX_GT = 128  # the CLI's --max-gt
# the CLI runs of the child (--det-train), beside scale_out: (name, steps,
# checkpoints written, flags)
DET_TRAIN_RUNS = (("lidar", 10, (5, 10), ["--save-every", "5"]),
                  ("camera", 2, (2,), ["--batch-size", "2", "--camera", "--image-aug", "--grid-mask", "0.5"]))
DET_TRAIN_TIMEOUT_S = 420  # the child's wait after scale_out


def det_train_step(model, batch, tx=None):
    """One training step of `model` on `batch` (the CLI's loss config):
    (loss, metrics, match, gradients by name); with `tx` the update is
    applied too."""
    import torch

    from mobi_tpu_torch.models import detector_training as DT

    loss, metrics, match = DT.detector_loss_fn(model, batch, DT.default_loss_config(model), return_match=True)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    if tx is not None:
        tx.step(grads)
    return loss.detach(), {k: float(v.detach()) for k, v in metrics.items()}, match, dict(zip(names, grads))


def phase_det_train_step(det, smi: str):
    """The lidar detector's training step at the production grid, card
    against CPU (DET_TRAIN_* above), then DET_TRAIN_TIMED_STEPS more on the
    card timed with CUDA events (forward, loss with the host Hungarian,
    backward, update), their peak memory above what was resident, and one
    more under torch.profiler for the device's busy share of a step (its
    kernel seconds over the timed steps' median wall)."""
    import numpy as np
    import torch

    from mobi_tpu_torch.data.det_pipeline import object_name_filter
    from mobi_tpu_torch.detector_inference import build_detector
    from mobi_tpu_torch.models import detector_training as DT
    from mobi_tpu_torch.models.bevfusion import BEVFusionDetector
    from mobi_tpu_torch.train_detector import NUSC_CLASSES

    t_phase = time.perf_counter()
    ex, lidar_in = det["ex"], det["lidar_in"]
    sd = det_unit_state_dict(BEVFusionDetector(use_camera=False, device="cpu"), SEED + 1)
    boxes = np.concatenate([ex["gt_bboxes_3d"], np.nan_to_num(ex["gt_velocity"].reshape(-1, 2))], 1)
    boxes, labels = object_name_filter(boxes, ex["gt_names"], NUSC_CLASSES)

    def batch_on(dev):
        return {"lidar": (lidar_in[0].to(dev),) + lidar_in[1:],
                **DT.gt_tensors(boxes, labels, DET_TRAIN_MAX_GT, dev)}

    cpu_model, card_model = build_detector(sd, False, device="cpu"), build_detector(sd, False, device="cuda")
    t0 = time.perf_counter()
    ref = det_train_step(cpu_model, batch_on("cpu"))
    cpu_s = time.perf_counter() - t0
    card_batch = batch_on("cuda")
    card = det_train_step(card_model, card_batch)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = det_train_step(card_model, card_batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def compare(run):
        loss, metrics, match, grads = run
        names = list(grads)
        got = torch.cat([grads[k].detach().cpu().reshape(-1) for k in names])
        want = torch.cat([ref[3][k].reshape(-1) for k in names])
        per = {k: float((grads[k].detach().cpu() - ref[3][k]).norm() / ref[3][k].norm().clamp_min(1e-30))
               for k in names}
        return {"same_matching": bool(torch.equal(match.cpu(), ref[2])),
                "loss_rel": abs(float(loss) - float(ref[0])) / abs(float(ref[0])),
                "terms_rel": {k: abs(metrics[k] - ref[1][k]) / max(abs(ref[1][k]), 1e-30) for k in ref[1]},
                "grad_rel_l2": float((got - want).norm() / want.norm()),
                "worst_tensors": sorted(per.items(), key=lambda kv: -kv[1])[:4]}

    row, control = compare(card), compare(tf32)
    passed = lambda r: r["same_matching"] and r["loss_rel"] <= DET_TRAIN_LOSS_RTOL and r["grad_rel_l2"] <= DET_TRAIN_GRAD_REL_L2

    # time the step on the card (the first update from the compared gradients)
    tx = DT.make_detector_optimizer(card_model)
    tx.step(list(card[3].values()))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms, walls, losses = [], [], []
    for _ in range(DET_TRAIN_TIMED_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss, metrics, _, _ = det_train_step(card_model, card_batch, tx)
        end.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        ms.append(start.elapsed_time(end))
        losses.append(metrics["loss"])
    peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
    t0 = time.perf_counter()
    classes, top = profile_classes(lambda: det_train_step(card_model, card_batch, tx))
    profiled_wall = time.perf_counter() - t0
    kernel_s = sum(classes.values())
    line = {"phase": "det_train_step", "precision": "fp32, TF32 off", "voxels": int(lidar_in[0].shape[0]),
            "gt": int(len(boxes)), "num_pos": card[1]["num_pos"], "loss": float(card[0]),
            "card_vs_cpu": {**row, "tolerance": {"loss_rel": DET_TRAIN_LOSS_RTOL,
                                                 "grad_rel_l2": DET_TRAIN_GRAD_REL_L2}},
            "tf32_control": control, "cpu_step_s": cpu_s,
            "card_step_ms": ms, "card_step_median_ms": statistics.median(ms), "step_wall_s": walls,
            "losses_after_updates": losses, "peak_above_resident_gib": peak,
            # the profiler's own cost stretches the profiled step's wall, so
            # the busy share is its kernel seconds over the timed median
            "profiled_step": {"kernel_s": kernel_s, "profiled_wall_s": profiled_wall,
                              "busy_share": kernel_s / statistics.median(walls), "classes": classes,
                              "top": top[:6]},
            "phase_s": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    finite = all(math.isfinite(v) for v in [float(card[0])] + losses)
    if not (passed(row) and not passed(control) and finite and card[1]["num_pos"] > 0):
        raise AssertionError(f"det_train_step: {json.dumps(line)[:3000]}")
    del cpu_model, card_model, tx
    return line


# CenterPoint at the production widths (in_channels 512 of SECONDFPN's
# output, BEV 180 x 180, 10 classes, 500 detections) on a seeded BEV with
# CENTERPOINT_GT boxes padded to 2x: card against CPU in fp32 with TF32 off,
# every output map within DET_REL_L2 relative L2, the loss within
# DET_TRAIN_LOSS_RTOL, the gradients of every parameter within
# DET_TRAIN_GRAD_REL_L2; decode's labels and (class, cell) indices equal on
# the same maps, and on each side's own maps reported; a TF32-on control
# must miss. CENTERPOINT_TIMED_STEPS steps (forward, decode, loss,
# backward) timed with CUDA events.
CENTERPOINT_GT = 12
CENTERPOINT_TIMED_STEPS = 3
# The point ops at a PAConv-sized shape: B clouds of N points, npoint
# centres with K neighbours, M weight banks, D channels (PAConv's first SA
# layer: 1024 centres, 32 neighbours, 8 banks, 64 channels). Gathers
# bitwise; the contractions within POINT_OPS_REL_L2 of the CPU (fp32, TF32
# off).
POINT_OPS_SHAPE = dict(b=4, n=4096, npoint=1024, k=32, m=8, d=64)
POINT_OPS_REL_L2 = 1e-6


def phase_centerpoint(smi: str):
    """CenterPoint's forward, decode, loss and backward at the production
    widths, card against CPU (see CENTERPOINT_* above)."""
    import torch

    from mobi_tpu_torch.models.centerpoint import CenterHead, centerpoint_loss
    from mobi_tpu_torch.models.transfusion_loss import TransFusionLossConfig
    from mobi_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    torch.manual_seed(SEED)
    cpu = CenterHead(device="cpu")
    card = CenterHead(device="cuda")
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(SEED + 5)
    bev = torch.randn(1, 512, 180, 180, generator=g)
    G = 2 * CENTERPOINT_GT
    boxes = torch.zeros(1, G, 9)
    boxes[0, :CENTERPOINT_GT, :2] = torch.rand(CENTERPOINT_GT, 2, generator=g) * 100 - 50
    boxes[0, :CENTERPOINT_GT, 2] = -1.5 + torch.rand(CENTERPOINT_GT, generator=g)
    boxes[0, :CENTERPOINT_GT, 3:6] = 0.5 + torch.rand(CENTERPOINT_GT, 3, generator=g) * 4
    boxes[0, :CENTERPOINT_GT, 6:] = torch.randn(CENTERPOINT_GT, 3, generator=g)
    labels = torch.randint(0, 10, (1, G), generator=g)
    mask = torch.arange(G)[None] < CENTERPOINT_GT
    cfg = TransFusionLossConfig()

    def step(head):
        dev = next(head.parameters()).device
        x = bev.to(dev)
        preds = head(x)
        det = head.decode({k: v.detach() for k, v in preds.items()})
        _, top = head.top_k(preds["heatmap"].detach())
        loss, metrics = centerpoint_loss(preds, boxes.to(dev), labels.to(dev), mask.to(dev), cfg)
        names, params = zip(*head.named_parameters())
        grads = torch.autograd.grad(loss, params)
        return {"preds": preds, "det": det, "top": top, "loss": loss.detach(), "num_pos": metrics["num_pos"],
                "grads": dict(zip(names, grads))}

    def cpu_of(x):
        return x.detach().cpu()

    _build.reset_launches()
    ref = step(cpu)
    got = step(card)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = step(card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    # decode on the card of the CPU's own maps: the peaks, the sort and the
    # gathers alone
    same_maps = card.decode({k: v.detach().cuda() for k, v in ref["preds"].items()})
    same_top = card.top_k(ref["preds"]["heatmap"].detach().cuda())[1]

    def compare(run):
        maps = {k: float((cpu_of(run["preds"][k]) - ref["preds"][k].detach()).norm() / ref["preds"][k].detach().norm())
                for k in ref["preds"]}
        names = list(ref["grads"])
        gw = torch.cat([ref["grads"][k].reshape(-1) for k in names])
        gg = torch.cat([cpu_of(run["grads"][k]).reshape(-1) for k in names])
        return {"maps_rel_l2": maps, "loss_rel": abs(float(run["loss"]) - float(ref["loss"])) / abs(float(ref["loss"])),
                "grad_rel_l2": float((gg - gw).norm() / gw.norm()),
                "own_maps_same_indices": bool(torch.equal(cpu_of(run["top"]), ref["top"])),
                "own_maps_same_labels": bool(torch.equal(cpu_of(run["det"]["labels"]), ref["det"]["labels"]))}

    def passed(r):
        return (max(r["maps_rel_l2"].values()) <= DET_REL_L2 and r["loss_rel"] <= DET_TRAIN_LOSS_RTOL
                and r["grad_rel_l2"] <= DET_TRAIN_GRAD_REL_L2)

    row, control = compare(got), compare(tf32)
    row["same_maps"] = {
        "indices_equal": bool(torch.equal(cpu_of(same_top), ref["top"])),
        "labels_equal": bool(torch.equal(cpu_of(same_maps["labels"]), ref["det"]["labels"])),
        "boxes_max_abs": float((cpu_of(same_maps["bboxes"]) - ref["det"]["bboxes"]).abs().max()),
        "scores_max_abs": float((cpu_of(same_maps["scores"]) - ref["det"]["scores"]).abs().max())}
    ms = []
    for _ in range(CENTERPOINT_TIMED_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(card)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    launches = dict(_build.launches)
    ties = int((ref["det"]["scores"] == ref["det"]["scores"][0, -1]).sum())
    line = {"phase": "centerpoint", "precision": "fp32, TF32 off", "bev": [1, 512, 180, 180], "classes": 10,
            "detections": card.max_detections, "gt": CENTERPOINT_GT, "gt_padded_to": G,
            "num_pos": float(ref["num_pos"]), "loss": float(ref["loss"]), "ties_at_the_last_score": ties,
            "card_vs_cpu": {**row, "tolerance": {"maps_rel_l2": DET_REL_L2, "loss_rel": DET_TRAIN_LOSS_RTOL,
                                                 "grad_rel_l2": DET_TRAIN_GRAD_REL_L2}},
            "tf32_control": control, "step_ms": ms, "step_median_ms": statistics.median(ms),
            "launches": {k: v for k, v in launches.items() if v}, "phase_s": time.perf_counter() - t_phase,
            "card": smi}
    emit(line)
    same = row["same_maps"]
    if not (passed(row) and not passed(control) and same["indices_equal"] and same["labels_equal"]
            and same["boxes_max_abs"] <= 1e-5 and same["scores_max_abs"] <= 1e-6 and float(ref["num_pos"]) > 0
            and not any(launches.values())):
        raise AssertionError(f"centerpoint: {json.dumps(line)[:3000]}")
    return launches


def phase_point_ops(smi: str):
    """The four point ops at POINT_OPS_SHAPE, card against CPU: the gathers
    bitwise, three_interpolate (fed from native.three_nn on the host) and
    the three aggregates of assign_score_withk within POINT_OPS_REL_L2."""
    import numpy as np
    import torch

    from mobi_tpu_torch import native
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.ops import point_ops as po

    t_phase = time.perf_counter()
    sh = POINT_OPS_SHAPE
    b, n, npoint, k, m, d = (sh[x] for x in ("b", "n", "npoint", "k", "m", "d"))
    rng = np.random.default_rng(SEED)
    xyz = rng.uniform(-10, 10, (b, n, 3)).astype(np.float32)
    feats = rng.standard_normal((b, n, m * d)).astype(np.float32)
    centres = np.stack([native.furthest_point_sample(x, npoint) for x in xyz]).astype(np.int64)
    knn = np.stack([native.knn(x, x[c], k)[0] for x, c in zip(xyz, centres)]).astype(np.int64)
    nn3 = [native.three_nn(x, x[c]) for x, c in zip(xyz, centres)]
    w = np.stack([1.0 / (d2 + 1e-8) for d2, _ in nn3])
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    idx3 = np.stack([i for _, i in nn3]).astype(np.int64)
    scores = rng.standard_normal((b, npoint, k, m)).astype(np.float32)
    centre_feats = rng.standard_normal((b, n, m, d)).astype(np.float32)
    sparse = feats[np.arange(b)[:, None], centres]  # [B, npoint, C]: the known features to interpolate

    def ops(dev):
        t = {name: torch.from_numpy(a).to(dev) for name, a in (
            ("feats", feats), ("centres", centres), ("knn", knn), ("idx3", idx3), ("w", w), ("scores", scores),
            ("centre_feats", centre_feats), ("sparse", sparse))}
        out = {"gather_points": po.gather_points(t["feats"], t["centres"]),
               "group_points": po.group_points(t["feats"], t["knn"]),
               "three_interpolate": po.three_interpolate(t["sparse"], t["idx3"], t["w"])}
        for agg in ("sum", "avg", "max"):
            out[f"assign_score_{agg}"] = po.assign_score_withk(t["scores"], t["feats"].reshape(b, n, m, d),
                                                               t["centre_feats"], t["knn"], agg)
        return out

    _build.reset_launches()
    ref = ops("cpu")
    got = {name: v.cpu() for name, v in ops("cuda").items()}
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    rows = {}
    for name, want in ref.items():
        if name in ("gather_points", "group_points"):
            rows[name] = {"bitwise": bool(torch.equal(got[name], want)), "shape": list(want.shape)}
        else:
            rows[name] = {"rel_l2": float((got[name] - want).norm() / want.norm()), "shape": list(want.shape)}
    line = {"phase": "point_ops", "shape": sh, "precision": "fp32, TF32 off", "ops": rows,
            "tolerance_rel_l2": POINT_OPS_REL_L2, "launches": {k: v for k, v in launches.items() if v},
            "phase_s": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    if not all(r["bitwise"] if "bitwise" in r else r["rel_l2"] <= POINT_OPS_REL_L2 for r in rows.values()) \
            or any(launches.values()):
        raise AssertionError(f"point_ops: {json.dumps(line)}")
    return launches


# CPU threads of each process that runs beside scale_out: torch's default,
# a thread a core in each of the seven processes there, oversubscribes the
# 8 cores of a one-card H100 host several times over
CHILD_THREADS = {"scale_out_rank": 2, "oracle_tiny": 1, "detection_plan": 1, "detection": 3, "lifecycle": 2,
                 "legacy": 2}


def child_env(name: str, **extra):
    """os.environ for the child `name`, its CPU threads (torch's intra-op
    pool, OpenMP, BLAS) held to CHILD_THREADS[name]."""
    n = str(CHILD_THREADS[name])
    return {**os.environ, "OMP_NUM_THREADS": n, "MKL_NUM_THREADS": n, "OPENBLAS_NUM_THREADS": n, **extra}


def detection_child(out_path: str) -> int:
    """python3 chip_smoke.py --detection OUT: beside scale_out, the host-bound
    detection work in order: the detection phase (phase_detection), the
    training step card against CPU (phase_det_train_step), CenterPoint and
    the point ops card against CPU (phase_centerpoint, phase_point_ops),
    then the detector training CLI (mobi_tpu_torch.train_detector main) at the
    production grid on the detection phase's raw tree: a GT database built
    by the port, DET_TRAIN_RUNS, the lidar run's last checkpoint through
    detection_eval's inference (run_detector) on one sample. Writes to OUT
    as JSON the phases' lines, each part's K1-K6 launches, and the CLI
    runs' histories, host and card timings, peak memory, checkpoints and
    the results' finiteness. A failed gate raises (exit 1)."""
    import contextlib
    import io

    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mobi_tpu_torch import train_detector
    from mobi_tpu_torch.data.det_pipeline import build_gt_database
    from mobi_tpu_torch.data.detection_dataset import DetectionSceneDataset
    from mobi_tpu_torch.detector_inference import run_detector
    from mobi_tpu_torch.ops import _build

    _build.library()  # the parent built it
    smi = nvidia_smi_line()
    det = phase_detection(smi)
    del det["models"]
    torch.cuda.empty_cache()
    phase_det_train_step(det, smi)
    torch.cuda.empty_cache()
    head_launches = {"centerpoint": phase_centerpoint(smi), "point_ops": phase_point_ops(smi)}
    torch.cuda.empty_cache()
    _build.reset_launches()
    root = Path(out_path).parent
    raw = det["raw"]
    t0 = time.perf_counter()
    db = build_gt_database(DetectionSceneDataset(raw, load_images=False), str(root / "gt_db"),
                           train_detector.NUSC_CLASSES)
    with open(db, "rb") as f:
        import pickle

        db_objects = {k: len(v) for k, v in pickle.load(f).items() if v}
    out = {"lines": _EMITTED, "detection_launches": det["launches"], "head_launches": head_launches,
           "gt_db_s": time.perf_counter() - t0,
           "gt_db_objects": db_objects, "runs": {}}
    for name, steps, _, flags in DET_TRAIN_RUNS:
        logdir = root / name
        timings = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            history = train_detector.main(["--dataroot", raw, "--logdir", str(logdir), "--max-steps", str(steps),
                                           "--sweeps", "2", "--gt-db", db] + flags, timings=timings)
        jsonl = (logdir / "metrics.jsonl").read_text().splitlines() if (logdir / "metrics.jsonl").exists() else []
        out["runs"][name] = {"wall_s": time.perf_counter() - t0, "history": history, "timings": timings,
                             "metrics_jsonl": [json.loads(x) for x in jsonl],
                             "checkpoints": sorted(p.name for p in logdir.glob("ckpt_*.pth")),
                             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                             "log_head": log.getvalue().splitlines()[:3]}
    # the lidar run's last checkpoint through detection_eval's inference
    # (run_detector: the strict load, the CLI's grid, one sample), every
    # proposal kept so that the boxes are there to check
    steps = DET_TRAIN_RUNS[0][1]
    t0 = time.perf_counter()
    path = run_detector(raw, str(root / "lidar" / f"ckpt_{steps}.pth"), str(root / "eval" / "results.json"),
                        sweeps_num=2, max_samples=1, score_threshold=0.0, box_convention="nusc")
    with open(path) as f:
        results = json.load(f)["results"]
    boxes = [b for dets in results.values() for b in dets]
    out["eval"] = {"seconds": time.perf_counter() - t0, "samples": len(results), "boxes": len(boxes),
                   "finite": all(math.isfinite(x) for b in boxes for x in b["translation"] + b["size"]
                                 + b["rotation"] + b["velocity"] + [b["detection_score"]])}
    out["launches"] = dict(_build.launches)
    Path(out_path).write_text(json.dumps(out))
    return 0


def detection_start(root: Path):
    """Start detection_child beside scale_out -> (the child, its log)."""
    root.mkdir(parents=True, exist_ok=True)
    log = open(root / "detection.log", "w")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--detection", str(root / "detection.json")],
                            stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT), env=child_env("detection"))
    return proc, log


def detection_finish(root: Path, proc, log, smi: str, timeout_s: float = DET_TRAIN_TIMEOUT_S):
    """Wait for detection_child (ended if it overruns), print its phases'
    lines again (`ran_beside`: scale_out), then the det_train line, gated:
    finite losses every step, num_pos > 0 on some step of each run, the
    metrics.jsonl line of every 10th step, the checkpoints asked for, the
    lidar checkpoint's one-sample results with boxes, finite, no K1-K6
    launch. Returns (the detection phase's launches, the CLI runs', those
    of CenterPoint and the point ops)."""
    try:
        proc.wait(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    if proc.returncode != 0:
        raise AssertionError(f"detection child (exit {proc.returncode}): "
                             f"{(root / 'detection.log').read_text()[-3000:]}")
    out = json.loads((root / "detection.json").read_text())
    for line in out["lines"]:
        emit({**line, "ran_beside": "scale_out", "child_t_s": line["t_s"]})
    bad = []
    runs = {}
    for name, steps, ckpts, _ in DET_TRAIN_RUNS:
        r = out["runs"][name]
        hist, tim = r["history"], r["timings"]
        runs[name] = {"steps": len(hist), "wall_s": r["wall_s"], "losses": [h["loss"] for h in hist],
                      "num_pos": [h["num_pos"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
                      "host_pipeline_s": [t["pipeline_s"] for t in tim], "host_plan_s": [t["plan_s"] for t in tim],
                      "card_step_ms": [t["step_ms"] for t in tim], "voxels": [t["voxels"] for t in tim],
                      "metrics_jsonl_steps": [m["step"] for m in r["metrics_jsonl"]],
                      "checkpoints": r["checkpoints"], "peak_gib": r["peak_gib"], "log_head": r["log_head"]}
        finite = all(math.isfinite(v) for h in hist for k, v in h.items())
        if (len(hist) != steps or not finite or max(runs[name]["num_pos"]) <= 0
                or runs[name]["metrics_jsonl_steps"] != list(range(10, steps + 1, 10))
                or r["checkpoints"] != sorted(f"ckpt_{s}.pth" for s in ckpts)):
            bad.append(name)
    ev = out["eval"]
    if not (ev["samples"] == 1 and ev["boxes"] > 0 and ev["finite"]):
        bad.append("eval")
    line = {"phase": "det_train", "ran_beside": "scale_out", "gt_db_s": out["gt_db_s"],
            "gt_db_objects": out["gt_db_objects"], "runs": runs, "eval": ev, "launches": out["launches"],
            "card": smi}
    emit(line)
    if bad or any(out["launches"].values()):
        raise AssertionError(f"det_train: {bad}: {json.dumps(line)[:3000]}")
    shutil.rmtree(root, ignore_errors=True)
    return out["detection_launches"], out["launches"], out["head_launches"]


def det_dense_models():
    """The detection phase's card models for phase_detection_dense, built
    again in this process: each detector with det_unit_state_dict's
    weights, and sample 0 of the raw tree (its camera inputs)."""
    from mobi_tpu_torch.data.detection_dataset import DetectionSceneDataset
    from mobi_tpu_torch.detector_inference import build_detector
    from mobi_tpu_torch.models.bevfusion import BEVFusionDetector

    ex = DetectionSceneDataset(str(ROOT / "build" / "detection" / "raw"), sweeps_num=2, image_size=(256, 704))[0]
    return {"models": {name: (build_detector(det_unit_state_dict(BEVFusionDetector(use_camera=uc, device="cpu"),
                                                                 SEED + 1), uc, device="cuda"), ex)
                       for name, uc, _ in DET_RUNS}}


def detection_plan_start(root: Path):
    """Start detection_plan_child beside scale_out -> (the child, its log)."""
    root.mkdir(parents=True, exist_ok=True)
    log = open(root / "detection_plan.log", "w")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--detection-plan",
                             str(root / "dense_plan.pkl")], stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT),
                            env=child_env("detection_plan"))
    return proc, log


def det_cells_in_forward(model, args, kw, ex):
    """The camera forward with its LSS cells made inside it, as a forward
    that takes the camera matrices must make them: wait for the card (the
    matrices' copy to the host), compute the cells on the host, copy them
    back. Against the plain forward, what `camera_inputs` making them in
    the host stage saves."""
    import torch

    def hook(vt, inputs):
        torch.cuda.synchronize()
        cells = vt.cells(ex["camera2lidar"], ex["camera_intrinsics"][:, :3, :3])
        return inputs[:2] + (cells.to(model.device),)

    handle = model.encoders["camera"]["vtransform"].register_forward_pre_hook(hook)
    try:
        return model(*args, **kw)
    finally:
        handle.remove()


def phase_detection_dense(det, proc, log, root: Path, smi: str, timeout_s: float = 300):
    """The real-density cloud: the child's host seconds, then each model's
    median card ms of DET_DENSE_FORWARDS forwards after a warm-up (CUDA
    events) and its peak memory above what was resident, with TF32 off and
    under PyTorch's default (cuDNN in TF32); the camera model's also with
    its LSS cells made inside the forward (det_cells_in_forward)."""
    import pickle

    import torch

    from mobi_tpu_torch.detector_inference import camera_inputs
    from mobi_tpu_torch.models.bevfusion import hard_simple_vfe

    try:
        proc.wait(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    if proc.returncode != 0:
        raise AssertionError(f"detection_plan (exit {proc.returncode}): "
                             f"{(root / 'detection_plan.log').read_text()[-3000:]}")
    with open(root / "dense_plan.pkl", "rb") as f:
        plan = pickle.load(f)
    n_vox = len(plan["voxels"])
    rows = {}
    for name, (model, ex) in det["models"].items():
        dev = model.device
        feats = hard_simple_vfe(torch.from_numpy(plan["voxels"]).to(dev), torch.from_numpy(plan["npv"]).to(dev))
        for rb in plan["plans"].values():
            rb.pairs(dev)
        args = (feats, plan["plans"], plan["out_coords"], plan["out_shape"])
        kw = camera_inputs(model, {**ex, "points": plan["points"]}) if model.use_camera else {}
        calls = {"": lambda: model(*args, **kw)}
        if model.use_camera:
            calls["cells_in_forward_"] = lambda: det_cells_in_forward(model, args, kw, ex)
        rows[name] = {}
        # TF32 off (this script's setting), then PyTorch's default (cuDNN
        # convolutions in TF32, matmuls not), which the CLI runs under
        for label, cudnn_tf32 in (("tf32_off", False), ("torch_default", True)):
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
            rows[name][label] = row = {}
            try:
                for prefix, call in calls.items():
                    with torch.no_grad():
                        call()  # warm-up
                        torch.cuda.synchronize()
                        resident = torch.cuda.memory_allocated()
                        torch.cuda.reset_peak_memory_stats()
                        ms = []
                        for _ in range(DET_DENSE_FORWARDS):
                            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                            start.record()
                            out = call()
                            end.record()
                            torch.cuda.synchronize()
                            ms.append(start.elapsed_time(end))
                        peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
                    row.update({f"{prefix}ms": ms, f"{prefix}median_ms": statistics.median(ms),
                                f"{prefix}peak_above_resident_gib": peak,
                                f"{prefix}finite": all(bool(torch.isfinite(v.float()).all()) for v in out.values())})
            finally:
                torch.backends.cudnn.allow_tf32 = False
    pairs = {k: int(rb.counts.sum()) for k, rb in plan["plans"].items()}
    sites = {k: rb.n_out for k, rb in plan["plans"].items()}
    line = {"phase": "detection_dense", "points": len(plan["points"]), "voxels": n_vox,
            "voxel_range": list(DET_DENSE_VOXELS), "host_voxelize_s": plan["voxelize_s"],
            "host_plan_s": plan["plan_s"], "host_s": plan["voxelize_s"] + plan["plan_s"], "ran_beside": "scale_out",
            "rulebook_pairs": pairs, "sites": sites, "models": rows, "card": smi}
    emit(line)
    shutil.rmtree(root, ignore_errors=True)
    if not (DET_DENSE_VOXELS[0] <= n_vox <= DET_DENSE_VOXELS[1]) or not all(
            v for row in rows.values() for r in row.values() for k, v in r.items() if k.endswith("finite")):
        raise AssertionError(f"detection_dense: {json.dumps(line)[:3000]}")
    return line


def tiny_oracle_config():
    """tests/test_diffusion.py's TINY (u_cond_percent 0, as
    tests/test_overfit_oracle.py sets it) with every routed attention on
    the kernels, and its tiny conditioning tower
    (tests/test_diffusion.py::TinyCondStage's widths)."""
    from mobi_tpu_torch.models.diffusion import MobiConfig
    from mobi_tpu_torch.models.encoders import CondStageModel

    cfg = MobiConfig(latent_size=8, image_height=32, range_height=32, unet_channels=32, unet_channel_mult=(1, 2),
                     unet_num_res_blocks=1, unet_attention_resolutions=(2, 1), unet_num_heads=4, context_dim=64,
                     ref_image_size=32, vae_ch=16, vae_ch_mult=(1, 1, 2), vae_num_res_blocks=1, clip_width=96,
                     u_cond_percent=0.0, attn_backend="flash")
    cond = CondStageModel(clip_width=96, clip_image_size=32, clip_patch_size=16, clip_layers=2, clip_heads=4,
                          mapper_layers=2, bbox_proj_dims=(64, 48, 48, 64))
    return cfg, cond


def tiny_kernels_vs_plain(model, batch, num_steps: int):
    """At the trained tiny weights, the learning path through the kernels
    against the same through the plain versions (every attention by the plain
    formula under autograd): the whole UNet's gradient of one training loss
    at a fixed t, noise and no drop (fp32 K3, K4 and K5 at d = 8 and 16),
    relative L2 within FP32_GRAD_REL_L2, and the DDIM-`num_steps` latents
    from one x_T (K1), relative L2 within num_steps x FP32_UNET_REL_L2 (each
    step adds one forward's error). Returns both errors and the launches
    of the kernel runs."""
    import torch

    from mobi_tpu_torch.models.diffusion import UNET_PREFIX, _to_device
    from mobi_tpu_torch.models.unet import CrossAttention
    from mobi_tpu_torch.ops import _build

    cfg, dev = model.config, model.device
    params = [p for n, p in model.named_parameters() if n.startswith(UNET_PREFIX)]
    attns = [m for m in model.unet.modules() if isinstance(m, CrossAttention)]
    saved = [m.attn_backend for m in attns]
    dev_batch = _to_device(batch, dev)
    b, s = 2 * len(batch["image"]["GT"]), cfg.latent_size
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    t = torch.randint(0, cfg.timesteps, (b,), generator=g, device=dev)
    noise = torch.randn(b, s, s, 4, generator=g, device=dev)
    x_T = torch.randn(b, s, s, 4, generator=g, device=dev)

    def run(plain: bool):
        if plain:
            for m in attns:
                m.attn_backend = "xla"
        _build.reset_launches()
        try:
            for p in params:
                p.requires_grad_(True)
                p.grad = None
            g.manual_seed(SEED + 6)  # the same posterior draws in both runs
            loss, _ = model.training_loss(dev_batch, g, t=t, noise=noise, drop=False)
            loss.backward()
            grad = torch.cat([p.grad.flatten() for p in params])
            with torch.no_grad():
                data = model.get_input(dev_batch, g, encode_cond=True, deterministic=True)
                lat = model.sample(data, g, num_steps=num_steps, guidance_scale=1.0, sampler="ddim", x_T=x_T)
            torch.cuda.synchronize()
        finally:
            for m, was in zip(attns, saved):
                m.attn_backend = was
            for p in params:
                p.grad = None
                p.requires_grad_(False)
        return grad, lat.float(), dict(_build.launches)

    grad_ref, lat_ref, _ = run(True)
    grad, lat, launched = run(False)
    out = {"grad_rel_l2": float((grad - grad_ref).norm() / grad_ref.norm()), "grad_tol": FP32_GRAD_REL_L2,
           "ddim_latents_rel_l2": float((lat - lat_ref).norm() / lat_ref.norm()),
           "ddim_tol": num_steps * FP32_UNET_REL_L2, "grad_elements": int(grad.numel()),
           "launches": {k: v for k, v in launched.items() if v}}
    if not (out["grad_rel_l2"] <= out["grad_tol"] and out["ddim_latents_rel_l2"] <= out["ddim_tol"]):
        raise AssertionError(f"oracle tiny: the kernels disagree with the plain versions at the trained weights: {out}")
    return out


def oracle_tiny_gate():
    """(a): train -> sample at the tiny config through the kernels (fp32:
    K3, K4, K5 in every training step, K1 in every sampling step), with
    tests/test_overfit_oracle.py's steps, lr and seeds. Gated: its VAE and
    loss thresholds; at the trained weights the kernels against the plain
    versions (`tiny_kernels_vs_plain`); and, over ORACLE_TINY_DRAWS noise
    draws, that training moved the sampled inpaints as it moves the JAX
    package's on every init the witness ran (PERF.md §6): the camera mean
    over the do-nothing baseline and over the untrained mean, the lidar mean
    over the untrained mean. Its sampled thresholds are checked on each
    draw and on the JAX test's own (DDIM-10 from seed 7) and reported with
    how many draws pass each: the JAX package passes them on its own draw
    from PRNGKey(0) and on few others, and on none from PRNGKey(1)
    (tests/test_torch_oracle_witness.py), so they measure the draw and the init.
    Returns its line's numbers and the launches of each part."""
    import numpy as np
    import torch

    from mobi_tpu_torch import overfit_oracle as O
    from mobi_tpu_torch.ops import _build

    t0 = time.perf_counter()
    cfg, cond = tiny_oracle_config()
    model = O.oracle_model(cfg, device="cuda", seed=SEED, cond_stage_model=cond)
    batch = O.make_object_set(4, 32, 32, seed=0)
    steps, gate = ORACLE_TINY_STEPS, ORACLE_TINY_GATE
    n_calls = len(unet_flash_calls(cfg, 8, "flash"))
    launches, seconds = {}, {}

    def counted(label, fn, want):
        _build.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t
        launches[label] = dict(_build.launches)
        if launches[label] != want:
            raise AssertionError(f"oracle tiny {label} launches {launches[label]}, expected {want}")
        return out

    def draws(seeds):
        return [O.sample_and_score(model, batch, num_steps=steps["sample"], seed=s) for s in seeds]

    seeds = list(range(ORACLE_TINY_DRAWS))
    sample = launch_counts(flash_fwd=len(seeds) * steps["sample"] * n_calls)
    untrained = counted("untrained_ddim", lambda: draws(seeds), sample)
    vae = counted("vae", lambda: O.overfit_vaes(model, batch, steps=steps["vae"]), launch_counts())
    train = steps["diffusion"] * n_calls
    _, diff = counted("diffusion", lambda: O.overfit_diffusion(model, batch, steps=steps["diffusion"], lr=3e-4),
                      launch_counts(flash_fwd_lse=train, flash_bwd_dq=train, flash_bwd_dkv=train))
    for p in model.parameters():
        p.requires_grad_(False)
    trained = counted("trained_ddim", lambda: draws([7] + seeds),
                      launch_counts(flash_fwd=(1 + len(seeds)) * steps["sample"] * n_calls))
    t = time.perf_counter()
    vs_plain = tiny_kernels_vs_plain(model, batch, steps["sample"])
    seconds["kernels_vs_plain"] = time.perf_counter() - t

    def sampled_checks(t, u):
        c, lid = t["camera_psnr"], t["lidar_psnr"]
        return {"camera_margin": c > t["camera_psnr_baseline"] + gate["camera_margin_db"],
                "camera_min": c > gate["camera_min_db"],
                "lidar_margin": lid > t["lidar_psnr_baseline"] + gate["lidar_margin_db"],
                "lidar_min": lid > gate["lidar_min_db"],
                "camera_over_untrained": c > u["camera_psnr"] + gate["camera_over_untrained_db"],
                "lidar_over_untrained": lid > u["lidar_psnr"] + gate["lidar_over_untrained_db"],
                "depth_mse": t["lidar_depth_mse"] < gate["depth_mse_max"]}

    def mean(rows):
        return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}

    own = sampled_checks(trained[0], untrained[seeds.index(7)])  # the JAX test's untrained draw is seed 7 too
    per_draw = [sampled_checks(t, u) for t, u in zip(trained[1:], untrained)]
    t_mean, u_mean = mean(trained[1:]), mean(untrained)
    gated = {
        "vae_l1": max(vae.values()) < gate["vae_l1_max"],
        "final_loss": diff["final_loss"] < gate["final_loss_max"],
        "kernels_vs_plain": True,  # tiny_kernels_vs_plain raised otherwise
        "camera_mean_over_baseline": t_mean["camera_psnr"] > t_mean["camera_psnr_baseline"],
        "camera_mean_over_untrained": t_mean["camera_psnr"] > u_mean["camera_psnr"],
        "lidar_mean_over_untrained": t_mean["lidar_psnr"] > u_mean["lidar_psnr"],
    }
    row = {"config": "tests/test_diffusion.py TINY, fp32, attn_backend flash", "steps": steps,
           "unet_flash_calls": n_calls, "vae_final_l1": vae, "diffusion_final_loss": diff["final_loss"],
           "thresholds": gate, "gated": gated, "kernels_vs_plain": vs_plain,
           "jax_test_draw": {"seed": 7, "trained": trained[0], "checks": own, "all": all(own.values())},
           "draws": len(seeds), "trained_mean": t_mean, "untrained_mean": u_mean,
           "draws_passing_each": {k: sum(d[k] for d in per_draw) for k in own},
           "draws_passing_all": sum(all(d.values()) for d in per_draw),
           "launches": {k: {n: v for n, v in c_.items() if v} for k, c_ in launches.items()},
           "seconds_by_part": seconds, "seconds": time.perf_counter() - t0}
    if not all(gated.values()):
        raise AssertionError(f"oracle tiny gate failed: {row}")
    del model
    torch.cuda.empty_cache()
    return row, launches


# The lifecycle drive (python -m mobi_tpu_torch.lifecycle_drive, its five
# phases each in a process of its own) as a child of this file's run beside
# scale_out, on train_cli's final full-width checkpoint: the port's training
# feeds its inpaint, which feeds its detector eval.
LIFECYCLE_TIMEOUT_S = 420  # the child's wait after scale_out


def lifecycle_start(root: Path, ckpt: str):
    """Start the drive under `root` with MOBI_LIFECYCLE_CKPT=ckpt -> (the
    child, its log)."""
    root.mkdir(parents=True, exist_ok=True)
    log = open(root / "lifecycle.log", "w")
    env = child_env("lifecycle", MOBI_LIFECYCLE_DIR=str(root / "work"), MOBI_LIFECYCLE_CKPT=ckpt)
    proc = subprocess.Popen([sys.executable, "-m", "mobi_tpu_torch.lifecycle_drive"], stdout=log,
                            stderr=subprocess.STDOUT, cwd=str(ROOT), env=env)
    return proc, log


def lifecycle_finish(root: Path, proc, log, smi: str, timeout_s: float = LIFECYCLE_TIMEOUT_S):
    """Wait for the drive (ended if it overruns) and print its line, gated:
    the drive's exit code and every phase's 0, each phase run (none found
    done), the bench's K1 launches in the inpaint phase equal to its batches
    x DDIM steps x the UNet's flash calls and no other kernel's, no kernel
    in any other phase, the eval's dataset reading edited files (a lidar
    cloud, the detector handed its points, and a camera frame from
    samples_seed321/), every sample in results.json, finite metrics.
    Returns each phase's launches."""
    from mobi_tpu_torch.lifecycle_drive import PHASES
    from mobi_tpu_torch.utils.config import load_config, mobi_config_from_yaml

    try:
        proc.wait(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (root / "lifecycle.log").read_text()
    if proc.returncode != 0:
        raise AssertionError(f"lifecycle drive (exit {proc.returncode}): {text[-3000:]}")
    summary = json.loads((root / "work" / "lifecycle.json").read_text())
    rec = summary["phases"]
    inp, det = rec["inpaint"], rec["detect"]
    cfg = mobi_config_from_yaml(load_config([str(ROOT / "configs" / "mobi_nusc_512.yaml")]))
    per_forward = len(unet_flash_calls(cfg, 16))  # a count that does not depend on the batch
    want = {name: {} for name in PHASES}
    want["inpaint"] = {"flash_fwd": inp["batches"] * inp["steps"] * per_forward}
    bad = [name for name in PHASES if rec[name]["rc"] != 0 or rec[name]["skipped"]
           or rec[name]["launches"] != want[name]]
    seen = det["edited_in_eval"]
    line = {"phase": "lifecycle", "ran_beside": "scale_out", "ckpt": inp["ckpt"],
            "wall_s": {name: rec[name]["wall_s"] for name in PHASES},
            "phase_s": {name: rec[name]["seconds"] for name in PHASES},
            "preprocess_objects": rec["preprocess"]["objects"],
            "inpaint": {k: inp[k] for k in ("objects", "batches", "steps", "device_s", "wall_s", "edited_files")},
            "edited_in_eval": seen, "mean_ap": det["mean_ap"], "nd_score": det["nd_score"],
            "tp_errors": det["tp_errors"], "results_samples": det["results_samples"], "boxes": det["boxes"],
            "detect_host_s": [t["host_s"] for t in det["timings"]],
            "detect_forward_s": [t["forward_s"] for t in det["timings"]],
            "launches": {name: rec[name]["launches"] for name in PHASES},
            "expected_launches": {k: v for k, v in want.items() if v}, "card": smi}
    emit(line)
    finite = all(math.isfinite(float(v)) for v in [det["mean_ap"], det["nd_score"], *det["tp_errors"].values()])
    if bad or not finite or not (seen["lidar"] >= 1 and seen["camera"] >= 1 and seen["clouds_equal"] == seen["lidar"]
                                 and det["results_samples"] == seen["samples"]):
        raise AssertionError(f"lifecycle: phases {bad}: {json.dumps(line)[:3000]}")
    shutil.rmtree(root, ignore_errors=True)
    return line["launches"]


def oracle_tiny_start(root: Path):
    """The tiny-config gate (`oracle_tiny_gate`) in a child process of this
    file (--oracle-tiny), so that its host-bound steps run beside the
    scale_out phase, whose parent only waits; its result goes to a JSON file
    under `root`. Returns (the child, its log file)."""
    root.mkdir(parents=True, exist_ok=True)
    log = open(root / "oracle_tiny.log", "w")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--oracle-tiny",
                             str(root / "oracle_tiny.json")], stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT),
                            env=child_env("oracle_tiny"))
    return proc, log


def oracle_tiny_finish(root: Path, proc, log, timeout_s: float):
    """Wait for the child of oracle_tiny_start (ended if it overruns),
    print its line -> (its row, the launches of each part)."""
    try:
        proc.wait(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    if proc.returncode != 0:
        raise AssertionError(f"oracle tiny (exit {proc.returncode}): "
                             f"{(root / 'oracle_tiny.log').read_text()[-3000:]}")
    out = json.loads((root / "oracle_tiny.json").read_text())
    emit({"phase": "oracle_tiny", "ran_beside": "scale_out", **out["row"]})
    shutil.rmtree(root, ignore_errors=True)
    return out["row"], out["launches"]


def phase_oracle(smi: str):
    """The learning path on the card (its tiny-config gate runs beside
    scale_out, `oracle_tiny_start`): the whole-UNet overfit at mini-256
    full width through the port's entry points
    (overfit_oracle.oracle_model, overfit_vaes, overfit_diffusion,
    make_inpaint_pipeline, SegmentedInpaint.preflight), counted, timed and
    profiled: the window-mean loss must fall, preflight must run, both
    samplers' outputs must be finite with the kernels launched as the
    flash-call count of the config says. Returns the launches of each path."""
    import numpy as np
    import torch

    from mobi_tpu_torch import overfit_oracle as O
    from mobi_tpu_torch import training as T
    from mobi_tpu_torch.models.diffusion import _to_device
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.pipeline import make_inpaint_pipeline
    from mobi_tpu_torch.utils.config import load_config, mobi_config_from_yaml

    t_phase = time.perf_counter()
    # mini-256 at full width (the YAML loader needs PyYAML)
    cfg = mobi_config_from_yaml(load_config([str(ROOT / "configs" / "mobi_nusc-mini_256.yaml")]))
    if cfg.dtype != torch.bfloat16 or cfg.latent_size != 32:
        raise AssertionError(f"mini-256 is expected in bf16 at latent 32, got {cfg.dtype}, {cfg.latent_size}")
    t0 = time.perf_counter()
    model = O.oracle_model(cfg, device="cuda", seed=SEED)
    batch = O.make_object_set(ORACLE_OBJECTS, cfg.image_height, cfg.image_height, seed=0,
                              ref_hw=(cfg.ref_image_size, cfg.ref_image_size))
    vae = O.overfit_vaes(model, batch, steps=ORACLE_VAE_STEPS, minibatch=4)
    torch.cuda.synchronize()
    vae_s = time.perf_counter() - t0

    unet_batch = 2 * ORACLE_OBJECTS
    per_step = len(unet_flash_calls(cfg, unet_batch))
    events = []

    def on_step(i, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    state, diff = O.overfit_diffusion(model, batch, steps=ORACLE_DIFF_STEPS, lr=3e-4, randomize_zero_init=True,
                                      adam_mu_dtype=torch.bfloat16, on_step=on_step)
    torch.cuda.synchronize()
    diff_s = time.perf_counter() - t0
    counts = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = ORACLE_DIFF_STEPS * per_step
    want = launch_counts(flash_fwd_lse=n, flash_bwd_dq=n, flash_bwd_dkv=n)
    if counts != want:
        raise AssertionError(f"oracle mini-256 diffusion launches {counts}, expected {want}")
    walls = [events[i - 1].elapsed_time(events[i]) / 1e3 for i in range(1, len(events))]
    med = statistics.median(walls[5:])
    losses = diff["losses"]
    first, last = float(np.mean(losses[:ORACLE_WINDOW])), float(np.mean(losses[-ORACLE_WINDOW:]))
    if not (all(math.isfinite(x) for x in losses) and last < first):
        raise AssertionError(f"oracle mini-256: the window-mean loss did not fall ({first} -> {last})")
    # device time of one more whole-UNet step, CUDA activity only
    train_step = T.make_train_step(model, state.opt)
    gen = torch.Generator(device=model.device).manual_seed(SEED + 7)
    dev_batch = _to_device(batch, model.device)
    classes, top = profile_classes(lambda: train_step(state, dev_batch, gen))
    busy = sum(classes.values())
    del train_step, state
    for p in model.parameters():
        p.requires_grad_(False)
        p.grad = None
    torch.cuda.empty_cache()

    # ---- sampling at guidance 5: DDIM-20 and segmented PLMS-20
    cfg_calls = len(unet_flash_calls(cfg, 2 * unet_batch))
    sampled, sample_launches = {}, {}
    for label, sampler, segments, evals in (("ddim20", "ddim", 1, ORACLE_SAMPLE_STEPS),
                                            ("plms20_segmented", "plms", ORACLE_PLMS_SEGMENTS,
                                             ORACLE_SAMPLE_STEPS + 1)):
        pipe = make_inpaint_pipeline(model, num_steps=ORACLE_SAMPLE_STEPS, guidance_scale=ORACLE_GUIDANCE,
                                     sampler=sampler, deterministic_encode=True, sample_segments=segments)
        if segments > 1:
            _build.reset_launches()
            ran = pipe.preflight(batch)
            torch.cuda.synchronize()
            sample_launches["preflight"] = dict(_build.launches)
            if ran is not True:
                raise AssertionError(f"SegmentedInpaint.preflight returned {ran} on the card")
        _build.reset_launches()
        t0 = time.perf_counter()
        out = pipe(batch, torch.Generator(device=model.device).manual_seed(7))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sample_launches[label] = dict(_build.launches)
        if sample_launches[label] != launch_counts(flash_fwd=evals * cfg_calls):
            raise AssertionError(f"oracle {label} launches {sample_launches[label]}, expected "
                                 f"{evals * cfg_calls} flash_fwd")
        for key, ch in (("camera", 3), ("lidar", 2)):
            shape = (ORACLE_OBJECTS, cfg.image_height, cfg.image_height, ch)
            if tuple(out[key].shape) != shape or not bool(torch.isfinite(out[key].float()).all()):
                raise AssertionError(f"oracle {label} {key}: shape {tuple(out[key].shape)} (want {shape}) "
                                     "or non-finite")
        sampled[label] = dict(O.score_inpaint({k: v.float().cpu().numpy() for k, v in out.items()}, batch),
                              wall_s=wall)
    mini = {"config": "configs/mobi_nusc-mini_256.yaml", "dtype": "bfloat16", "objects": ORACLE_OBJECTS,
            "parameters": sum(p.numel() for p in model.parameters()), "vae_steps": ORACLE_VAE_STEPS,
            "vae_final_l1": vae, "vae_s": vae_s, "diffusion_steps": ORACLE_DIFF_STEPS,
            "optimizer": "adamw, bf16 mu, LambdaLinear 200-step warm-up, zero-init knob",
            "zero_init_perturbed": len(diff["zero_init_perturbed"]),
            "loss_window_means": [first, last], "final_loss": diff["final_loss"], "diffusion_s": diff_s,
            "median_step_s": med, "device_busy_s_per_step": busy, "busy_share_of_median_step": busy / med,
            "device_s_by_class": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
            "peak_mem_gib": peak, "unet_batch": unet_batch,
            "launches_per_step": {k: v // ORACLE_DIFF_STEPS for k, v in counts.items() if v},
            "launches_per_step_expected": per_step, "preflight": True, "guidance": ORACLE_GUIDANCE,
            "sample_steps": ORACLE_SAMPLE_STEPS, "sampled_not_gated": sampled,
            "sample_launches": {k: {n_: v for n_, v in c.items() if v} for k, c in sample_launches.items()}}
    emit({"phase": "oracle", "mini256": mini,
          "phase_s": time.perf_counter() - t_phase, "card": smi})
    del model
    torch.cuda.empty_cache()
    return {"mini256_diffusion": counts, **{f"mini256_{k}": v for k, v in sample_launches.items()}}


# The scale_out phase. The CLI runs are train_cli's config and overrides
# with the dataset's draws pinned (no reference augmentation, erase boxes or
# random crops, fixed sampling: every item a function of its index), so one
# process at batch_size 2 and two ranks at batch_size 1 see the same global
# batches; the validation split cut to 1 object a class (1 global batch:
# under fsdp2 each of validation's 4 t draws, on the live and the EMA
# weights, gathers every block; 2 batches took 64 s of a 136 s rank run,
# this script, H100 80GB HBM3 at 700 W);
# the lr warm-up cut to 1 step, so the first steps move the weights by the
# config's whole lr and a wrong gradient mean shows in the updates. dp2 runs
# SCALE_OUT_STEPS steps, fsdp2 (4x dp2's step time) FSDP2_STEPS; the one
# process saves at both.
SCALE_OUT_STEPS, FSDP2_STEPS = 4, 2
SCALE_OUT_ARGS = ["--log_every", "1", "--image_log_steps", "2", "--image_log_max", "1",
                  "--save_top_k", "2", "--num_workers", "2"]
SCALE_OUT_DATA = ([f"data.params.{split}.params.{k}={v}" for split in ("train", "validation")
                   for k, v in (("ref_aug", False), ("prob_erase_box", 0.0), ("object_random_crop", False),
                                ("fixed_sampling", True))]
                  + ["data.params.validation.params.num_samples_per_class=1",
                     "model.params.scheduler_config.params.warm_up_steps=[1]"])
SCALE_OUT_TIMEOUT_S = 300
# Losses of two ranks at batch 1 against one process at batch 2 (the same
# draws): each call runs the bf16 kernels and GEMMs at another batch, so they
# round otherwise; measured 1.2e-5 to 7.9e-5 relative (this script, H100
# 80GB HBM3 at 700 W), gated at 1e-3. The one-rank NCCL mesh against the bare step
# runs the same calls: measured bitwise equal, gated at 1e-3 relative on the
# losses and 1e-2 relative L2 on the trainable weights' updates, the margin
# for a cuDNN backward that sums in another order.
SCALE_OUT_LOSS_RTOL = 1e-3
NCCL1_LOSS_RTOL, NCCL1_UPDATE_REL_L2 = 1e-3, 1e-2
# The trainable weights' updates of rank 0's checkpoint against the one
# process's at the same step (relative L2 over the whole trainable set):
# measured 0.021 (dp2, 4 steps) and 0.030 (fsdp2, 2 steps), AdamW's first
# steps flipping gradients near zero; the control with the mean over ranks
# skipped (--scale-out-control) 0.378 (this script, H100 80GB HBM3 at
# 700 W). Gated between the two.
SCALE_OUT_UPDATE_REL_L2 = 0.1
# fsdp2 keeps half of each divisible parameter, moment and shadow: its
# resident memory after the first step must stay under this share of dp2's.
# A step gathers a block or two whole at a time, and a checkpoint a bucket
# of pieces at a time, so its peak must not pass dp2's.
FSDP_RESIDENT_SHARE_MAX = 0.6
# fsdp2's peak a rank at most dp2's peak less this share of what fsdp2 saves
# at rest (dp2's resident less fsdp2's): a step holds whole only a block or
# two besides the root, so nearly all of the saving should reach the peak
FSDP_PEAK_SHARE_OF_SAVING = 0.7


def scale_out_nccl1():
    """The full-width adapter step (bf16, 2 pairs, the config's lr without
    its warm-up) twice: through the bare make_train_step, then on a
    one-rank NCCL mesh through the sharded step, with the same injected t,
    noise and drop (kept, then dropped) and the encodes' posterior draws
    from one seed. Returns the comparison line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mobi_tpu_torch import training as T
    from mobi_tpu_torch.models.diffusion import MobiConfig, MobiDiffusion
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.parallel import distributed as pdist
    from mobi_tpu_torch.parallel import mesh as pmesh

    cfg = MobiConfig(dtype=torch.bfloat16)
    batch = make_batch(TRAIN_PAIRS)
    rng = np.random.default_rng(SEED + 3)
    b = 2 * TRAIN_PAIRS
    draws = [dict(t=torch.from_numpy(rng.integers(0, cfg.timesteps, b)).cuda(),
                  noise=torch.from_numpy(rng.standard_normal((b, 64, 64, 4)).astype(np.float32)).cuda()
                  .to(torch.bfloat16), drop=drop) for drop in (False, True)]

    def run(mesh):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = MobiDiffusion(cfg, device="cuda", seed=SEED, for_training=True)
        state, tx = T.create_train_state(model, schedule=T.lambda_linear_schedule(TRAIN_LR, 1, 1.0), mesh=mesh)
        step = T.make_train_step(model, tx, mesh=mesh)
        start = {n: p.detach().float().cpu() for n, p in model.named_parameters() if p.requires_grad}
        data = batch if mesh is None else pmesh.shard_batch(mesh, batch)
        losses, launches, walls = [], [], []
        gen = torch.Generator(device="cuda").manual_seed(SEED + 4)  # the encodes' posterior draws
        for d in draws:
            _build.reset_launches()
            t1 = time.perf_counter()
            _, m = step(state, data, gen, **d)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
            launches.append({k: v for k, v in _build.launches.items() if v})
        updates = {n: p.detach().float().cpu() - start[n] for n, p in model.named_parameters() if p.requires_grad}
        out = {"losses": losses, "launches_per_step": launches, "step_walls_s": walls,
               "run_s": time.perf_counter() - t0, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        del model, state, tx, step
        torch.cuda.empty_cache()
        return out, updates

    bare, bare_upd = run(None)
    assert pdist.initialize(f"127.0.0.1:{socket_port()}", 1, 0)
    try:
        backend = dist.get_backend()
        mesh = pmesh.create_mesh()
        sharded, sharded_upd = run(mesh)
    finally:
        dist.destroy_process_group()
        pdist._DEVICE = None
    num = sum(float((sharded_upd[n] - u).norm() ** 2) for n, u in bare_upd.items())
    den = sum(float(u.norm() ** 2) for u in bare_upd.values())
    rel_upd = math.sqrt(num / den)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(sharded["losses"], bare["losses"])]
    line = {"phase": "scale_out", "case": "nccl1", "backend": backend, "mesh": mesh.shape, "pairs": TRAIN_PAIRS,
            "bare": bare, "sharded": sharded, "loss_rel_diff": loss_rel, "loss_rtol": NCCL1_LOSS_RTOL,
            "trainable_update_rel_l2": rel_upd, "update_rel_l2_max": NCCL1_UPDATE_REL_L2,
            "trainable_tensors": len(bare_upd)}
    emit(line)
    want = bare["launches_per_step"]
    if (sharded["launches_per_step"] != want or not all(k in want[0] for k in
                                                        ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"))
            or max(loss_rel) > NCCL1_LOSS_RTOL or not rel_upd <= NCCL1_UPDATE_REL_L2 or den == 0):
        raise AssertionError(f"scale_out nccl1: launches {sharded['launches_per_step']} vs {want}, loss rel "
                             f"{loss_rel}, update rel L2 {rel_upd}")
    return line


def socket_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def scale_out_cli_run(case, rank: int = 0):
    """One rank of the training CLI (in process when the world is 1), its
    training step's launches counted alone, the seconds of its validations
    and checkpoint saves; with case["keep_init"], the trainable weights
    before the first step (on the host)."""
    import torch

    from mobi_tpu_torch import checkpoint as C
    from mobi_tpu_torch import train as T
    from mobi_tpu_torch.ops import _build

    per_step, init, spent = [], {}, {"validate_s": [], "save_s": []}
    make, validate, save = T.make_train_step, T.validate, C.CheckpointManager.save

    def timed(key, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key].append(time.perf_counter() - t0)
        return wrapped

    def counted_make(model, tx, device=None, mesh=None):
        if case.get("keep_init"):
            init.update({n: p.detach().float().cpu() for n, p in model.named_parameters() if p.requires_grad})
        step = make(model, tx, device=device, mesh=mesh)

        def wrapped(*a, **k):
            before = dict(_build.launches)
            out = step(*a, **k)
            per_step.append({key: n - before.get(key, 0) for key, n in _build.launches.items()
                             if n - before.get(key, 0)})
            return out
        return wrapped

    argv = list(case["argv"])
    if case["world"] > 1:
        argv += ["--coordinator", f"127.0.0.1:{case['port']}", "--num_processes", str(case["world"]),
                 "--process_id", str(rank)]
    zero_init = os.environ.get("MOBI_RANDOMIZE_ZERO_INIT")
    os.environ["MOBI_RANDOMIZE_ZERO_INIT"] = "1"
    T.make_train_step, T.validate = counted_make, timed("validate_s", validate)
    C.CheckpointManager.save = timed("save_s", save)
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        stats = T.main(argv)
    finally:
        T.make_train_step, T.validate, C.CheckpointManager.save = make, validate, save
        if zero_init is None:
            del os.environ["MOBI_RANDOMIZE_ZERO_INIT"]
        else:
            os.environ["MOBI_RANDOMIZE_ZERO_INIT"] = zero_init
    return {"losses": stats["losses"], "run_s": time.perf_counter() - t0, "step_s": stats["step_s"],
            "epoch_s": [e["train/epoch_time_s"] for e in stats["epochs"]], **spent,
            "resident_bytes": stats["resident_bytes"], "world": stats["world"],
            "launches": {k: v for k, v in _build.launches.items() if v}, "launches_per_step": per_step,
            "logdir": stats["logdir"], "ckpt_dir": stats["ckpt_dir"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, **({"init": init} if init else {}),
            # the first step's own peak (the CLI's memory pre-flight), apart from the run's
            "first_step_peak_gib": sum(stats["preflight"][k] for k in (
                "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes")) / 2**30}


def scale_out_bench_run(case, rank: int):
    """One rank of inference_test_bench --mesh-dp 2 on the served model's
    weights (MobiConfig in bf16, seed SEED); rank 0 keeps batch 0's
    decoded outputs."""
    import numpy as np
    import torch

    from mobi_tpu_torch import inference_test_bench as bench
    from mobi_tpu_torch.models.diffusion import MobiConfig, MobiDiffusion
    from mobi_tpu_torch.ops import _build

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(case["world"]),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(case["port"]))
    model = MobiDiffusion(MobiConfig(dtype=torch.bfloat16), device="cuda", seed=SEED)
    make = bench.make_inpaint_pipeline
    kept = {}

    def recording(model_, **kw):
        run = make(model_, **kw)

        def call(batch, generator):
            out = run(batch, generator)
            kept.setdefault("out", {k: v.float().cpu().numpy() for k, v in out.items()})
            return out
        return call

    bench.make_inpaint_pipeline = recording
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        stats = bench.main(case["argv"], model=model)
    finally:
        bench.make_inpaint_pipeline = make
    if rank == 0:
        np.savez(os.path.join(case["root"], "batch0.npz"), **kept["out"])
    return {"objects": stats["objects"], "batches": stats["batches"], "wall_s": stats["wall_s"],
            "run_s": time.perf_counter() - t0, "launches": {k: v for k, v in _build.launches.items() if v},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def scale_out_rank(case_path: str, rank: int) -> int:
    """A rank of the scale_out phase (python3 chip_smoke.py --scale-out-rank
    CASE RANK): ranks share the card over gloo; every rank but 0 records each
    file it opens for writing under the case's directory (there must be
    none). Writes its result as JSON beside the case."""
    import builtins

    import torch

    case = json.loads(Path(case_path).read_text())
    sys.path.insert(0, str(ROOT))
    os.environ["MOBI_DIST_BACKEND"] = "gloo"
    if case.get("skip_grad_mean"):  # the control: each rank steps on its own gradient
        from mobi_tpu_torch.parallel import mesh as pmesh

        def local_grads(self, params):
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.scatter_()

        pmesh.ModelSharding.reduce_grads_ = local_grads
    writes = []
    if rank != 0:
        real_open, watched = builtins.open, os.path.abspath(case["root"])

        def watching_open(file, mode="r", *a, **k):
            if isinstance(file, (str, os.PathLike)) and any(c in mode for c in "wax+") \
                    and os.path.abspath(file).startswith(watched):
                writes.append(str(file))
            return real_open(file, mode, *a, **k)

        builtins.open = watching_open
    from mobi_tpu_torch.ops import _build

    _build.library()  # the parent built it
    out = scale_out_cli_run(case, rank) if case["kind"] == "cli" else scale_out_bench_run(case, rank)
    out.update(rank=rank, writes_outside_rank0=writes, device=torch.cuda.get_device_name(0))
    Path(case_path + f".rank{rank}.json").write_text(json.dumps(out))
    return 0


def scale_out_spawn(root: Path, name: str, case: dict, world: int):
    """Run `case` on `world` ranks of this file; {rank: result}. A rank that
    fails or overruns fails the phase; every rank is ended either way."""
    case = dict(case, world=world, port=socket_port(), root=str(root))
    path = root / f"{name}.json"
    path.write_text(json.dumps(case))
    logs = [open(root / f"{name}.rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--scale-out-rank", str(path), str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=str(ROOT), env=child_env("scale_out_rank"))
             for r in range(world)]
    deadline = time.time() + SCALE_OUT_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = {r: (root / f"{name}.rank{r}.log").read_text()[-3000:] for r in failed}
        raise AssertionError(f"scale_out {name}: ranks {failed} failed: {tails}")
    return {r: json.loads(Path(str(path) + f".rank{r}.json").read_text()) for r in range(world)}


def scale_out_train(root: Path, control: bool = False):
    """dp2 and fsdp2 of the scale_out phase: the training CLI as two ranks
    against one process at twice the batch, gated on the losses, the
    trainable weights' updates of rank 0's checkpoint against the one
    process's at the same step, the checkpoint, the launches and fsdp2's
    resident memory. With `control`, dp2 alone with each rank stepping on
    its own gradient (the mean skipped): its readings are printed, not
    gated. Returns {case: line}."""
    import torch

    from mobi_tpu_torch import checkpoint as C
    from mobi_tpu_torch import convert
    from mobi_tpu_torch.data.synthetic import build_synthetic_database
    from mobi_tpu_torch.models.diffusion import MobiConfig, MobiDiffusion

    keys = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
    db = build_synthetic_database(str(root / "db"), img_w=BENCH_IMG[0], img_h=BENCH_IMG[1], seed=SEED)
    overrides = (["model.params.scheduler_config.target=ldm.lr_scheduler.LambdaLinearScheduler",
                  "model.params.use_ema=True"]
                 + [f"data.params.{split}.params.{k}={v}" for split in ("train", "validation") for k, v in db.items()]
                 + SCALE_OUT_DATA)

    def argv(name, batch_size, steps, extra=()):
        every = [f"--{k}_every" for k in ("val", "save", "image_log")]
        return (["--base", str(ROOT / "configs" / "mobi_nusc_512.yaml"), "--logdir", str(root / name / "logs"),
                 "--max_steps", str(steps), "--seed", str(SEED)] + [a for k in every for a in (k, str(steps))]
                + SCALE_OUT_ARGS + list(extra) + overrides + [f"batch_size={batch_size}"])

    # the one-process reference: its losses, and its trainable weights'
    # updates at both saved steps (no validation or image log)
    ref = scale_out_cli_run({"argv": argv("one", 2, SCALE_OUT_STEPS, ["--val_every", "1000", "--image_log_every",
                                                                      "1000", "--save_every", str(FSDP2_STEPS)]),
                             "world": 1, "keep_init": True})
    init = ref.pop("init")
    ref_upd = {}
    for st in (FSDP2_STEPS, SCALE_OUT_STEPS):
        saved = C.read_step(os.path.join(ref["ckpt_dir"], str(st)), parts=("model",))["model"]
        ref_upd[st] = {n: saved[n].float() - w for n, w in init.items()}
        del saved
    torch.cuda.empty_cache()
    shutil.rmtree(ref["logdir"], ignore_errors=True)

    def update_rel_l2(model, step):
        got = dict(model.named_parameters())
        num = sum(float((got[n].detach().float().cpu() - init[n] - u).norm() ** 2)
                  for n, u in ref_upd[step].items())
        return math.sqrt(num / sum(float(u.norm() ** 2) for u in ref_upd[step].values()))

    calls1 = unet_flash_calls(MobiConfig(dtype=torch.bfloat16), 2)
    n_grad = len(train_flash_calls(MobiConfig(dtype=torch.bfloat16), 2))
    want_step = {k: v for k, v in launch_counts(flash_fwd=len(calls1) - n_grad, flash_fwd_lse=n_grad,
                                                flash_bwd_dq=n_grad, flash_bwd_dkv=n_grad).items() if v}
    lines, resident = {}, {}
    fresh = MobiDiffusion(MobiConfig(dtype=torch.bfloat16), device="cuda", seed=SEED + 1, for_training=True)
    # fsdp2 leaves the image log to dp2 (each costs fsdp a gather of every parameter)
    cases = [("dp2", SCALE_OUT_STEPS, [], {}), ("fsdp2", FSDP2_STEPS, ["--fsdp", "2", "--image_log_every", "1000"], {})]
    if control:
        cases = [("dp2_skip_grad_mean", SCALE_OUT_STEPS, ["--val_every", "1000", "--image_log_every", "1000"],
                  {"skip_grad_mean": True})]
    for name, n_steps, extra, flags in cases:
        res = scale_out_spawn(root, name, {"kind": "cli", "argv": argv(name, 1, n_steps, extra), **flags}, 2)
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(res[0]["losses"], ref["losses"])]
        ckpt_dir = res[0]["ckpt_dir"]
        steps = sorted(os.listdir(ckpt_dir))
        t0 = time.perf_counter()
        info = convert.load_checkpoint(fresh, ckpt_dir)
        load_s = time.perf_counter() - t0
        finite = all(bool(torch.isfinite(p.float()).all()) for p in fresh.parameters())
        rel_upd = update_rel_l2(fresh, n_steps)
        resident[name] = [res[r]["resident_bytes"].get("after_first_step", 0) for r in (0, 1)]
        line = {"phase": "scale_out", "case": name, "ranks": 2, "backend": "gloo", "batch_size_per_rank": 1,
                "steps": n_steps, "losses": {r: res[r]["losses"] for r in (0, 1)}, "one_process_losses": ref["losses"],
                "loss_rel_diff": loss_rel, "loss_rtol": SCALE_OUT_LOSS_RTOL,
                "trainable_update_rel_l2": rel_upd, "update_rel_l2_max": SCALE_OUT_UPDATE_REL_L2,
                "trainable_tensors": len(init),
                "launches_per_rank": {r: res[r]["launches"] for r in (0, 1)},
                "launches_per_step_per_rank": {r: res[r]["launches_per_step"][0] for r in (0, 1)},
                "want_per_step_at_1_pair": want_step,
                "run_s_per_rank": {r: res[r]["run_s"] for r in (0, 1)},
                "seconds_per_rank": {r: {k: res[r][k] for k in ("epoch_s", "validate_s", "save_s")} for r in (0, 1)},
                "median_step_s_per_rank": {r: statistics.median(res[r]["step_s"]) for r in (0, 1)},
                "peak_mem_gib_per_rank": {r: res[r]["peak_mem_gib"] for r in (0, 1)},
                "first_step_peak_gib_per_rank": {r: res[r]["first_step_peak_gib"] for r in (0, 1)},
                "resident_gib_per_rank": {r: {k: v / 2**30 for k, v in res[r]["resident_bytes"].items()}
                                          for r in (0, 1)},
                "one_process": {"run_s": ref["run_s"], "median_step_s": statistics.median(ref["step_s"]),
                                "peak_mem_gib": ref["peak_mem_gib"], "first_step_peak_gib": ref["first_step_peak_gib"],
                                "resident_gib": {k: v / 2**30 for k, v in ref["resident_bytes"].items()}},
                "checkpoint_steps": steps, "checkpoint_loaded": info["loaded"], "checkpoint_missing": info["missing"],
                "checkpoint_load_s": load_s, "rank1_writes": res[1]["writes_outside_rank0"]}
        if name == "fsdp2":
            line["resident_share_of_dp2"] = [f / d for f, d in zip(resident["fsdp2"], resident["dp2"])]
            line["resident_share_max"] = FSDP_RESIDENT_SHARE_MAX
            # per-block gathering: the step's peak falls with what fsdp saves at rest
            dp2_peak = lines["dp2"]["peak_mem_gib_per_rank"]
            line["peak_bound_gib_per_rank"] = {
                r: dp2_peak[r] - FSDP_PEAK_SHARE_OF_SAVING * (resident["dp2"][r] - resident["fsdp2"][r]) / 2**30
                for r in (0, 1)}
        emit(line)
        lines[name] = line
        shutil.rmtree(root / name, ignore_errors=True)
        if control:
            continue
        bad = (res[0]["losses"] != res[1]["losses"] or len(res[0]["losses"]) != n_steps
               or not all(math.isfinite(x) for x in res[0]["losses"]) or max(loss_rel) > SCALE_OUT_LOSS_RTOL
               or not rel_upd <= SCALE_OUT_UPDATE_REL_L2
               or steps != [str(n_steps)] or info["step"] != n_steps or info["missing"]
               or not finite or res[1]["writes_outside_rank0"]
               or any({k: v for k, v in res[r]["launches_per_step"][0].items() if k in keys} != want_step
                      for r in (0, 1))
               or any(res[r]["launches"].get("flash_fwd", 0) <= want_step.get("flash_fwd", 0) * n_steps
                      for r in (0, 1)))
        if name == "fsdp2":
            bad = (bad or max(line["resident_share_of_dp2"]) > FSDP_RESIDENT_SHARE_MAX
                   or max(line["peak_mem_gib_per_rank"].values()) > min(lines["dp2"]["peak_mem_gib_per_rank"].values())
                   or any(line["peak_mem_gib_per_rank"][r] > line["peak_bound_gib_per_rank"][r] for r in (0, 1)))
        if bad:
            raise AssertionError(f"scale_out {name}: {json.dumps(line)[:3000]}")
    del fresh
    torch.cuda.empty_cache()
    return lines


def phase_scale_out(smi: str, bench_ref):
    """The scale_out phase (see the module docstring). Returns the per-rank
    launches of each case for the kernels line."""
    import numpy as np
    import torch

    from mobi_tpu_torch.models.diffusion import MobiConfig

    t_phase = time.perf_counter()
    nccl1 = scale_out_nccl1()
    root = ROOT / "build" / "scale_out"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    lines = scale_out_train(root)

    # mesh_dp2: the bench's batch 0 of the test split on two ranks
    tb_db = bench_ref["db"]
    bench_argv = (["--config", str(ROOT / "configs" / "mobi_nusc_512.yaml")] + BENCH_ARGS
                  + ["--outdir", str(root / "bench"), "--max_batches", "1", "--mesh-dp", "2"]
                  + [f"data.params.test.params.{k}={v}" for k, v in tb_db.items()])
    res = scale_out_spawn(root, "mesh_dp2", {"kind": "bench", "argv": bench_argv}, 2)
    got = dict(np.load(root / "batch0.npz"))
    want = bench_ref["batch0"]
    rel = {k: float(np.linalg.norm(got[k] - want[k].numpy()) / np.linalg.norm(want[k].numpy()))
           for k in ("camera", "lidar")}
    per_rank_k1 = PLMS_EVALS * len(unet_flash_calls(MobiConfig(dtype=torch.bfloat16), 4 * BENCH_PAIRS // 2))
    segs = sorted(p.name[:-len("_grid_seed321.png")] for p in (root / "bench" / "camera" / "grid").iterdir())
    missing = [f.format(seg=s) for s in segs for f in BENCH_FILES if not (root / "bench" / f.format(seg=s)).is_file()]
    line = {"phase": "scale_out", "case": "mesh_dp2", "ranks": 2, "backend": "gloo", "objects": res[0]["objects"],
            "pairs_per_rank": BENCH_PAIRS // 2, "rel_l2_vs_one_process_batch0": rel, "rel_l2_max": UNET_REL_L2,
            "launches_per_rank": {r: res[r]["launches"] for r in (0, 1)}, "want_flash_fwd_per_rank": per_rank_k1,
            "device_s_per_rank": {r: [b["device_s"] for b in res[r]["batches"]] for r in (0, 1)},
            "wall_s_per_rank": {r: res[r]["wall_s"] for r in (0, 1)},
            "run_s_per_rank": {r: res[r]["run_s"] for r in (0, 1)},
            "peak_mem_gib_per_rank": {r: res[r]["peak_mem_gib"] for r in (0, 1)},
            "objects_written": segs, "files_missing": missing[:5],
            "metrics_csv": (root / "bench" / "metrics.csv").is_file(),
            "rank1_writes": res[1]["writes_outside_rank0"]}
    emit(line)
    lines["mesh_dp2"] = line
    if (any(res[r]["launches"] != {"flash_fwd": per_rank_k1} for r in (0, 1)) or res[1]["writes_outside_rank0"]
            or not line["metrics_csv"] or not segs or missing or res[0]["objects"] != BENCH_PAIRS
            or not all(math.isfinite(v) and v <= UNET_REL_L2 for v in rel.values())):
        raise AssertionError(f"scale_out mesh_dp2: {json.dumps(line)[:3000]}")
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "scale_out_done", "phase_s": time.perf_counter() - t_phase, "card": smi})
    launches = {"nccl1": {"per_step": nccl1["sharded"]["launches_per_step"][0]},
                **{name: {f"rank{r}": lines[name]["launches_per_rank"][r] for r in (0, 1)}
                   for name in ("dp2", "fsdp2", "mesh_dp2")},
                **{f"{name}_per_step": {f"rank{r}": lines[name]["launches_per_step_per_rank"][r] for r in (0, 1)}
                   for name in ("dp2", "fsdp2")}}
    return launches


def oracle_tiny_child(out_path: str) -> int:
    """The child of oracle_tiny_start (python3 chip_smoke.py --oracle-tiny
    OUT): the gate with the parent's TF32 settings, its row and launches
    written to OUT as JSON."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mobi_tpu_torch.ops import _build

    _build.library()  # the parent built it
    row, launches = oracle_tiny_gate()
    Path(out_path).write_text(json.dumps({"row": row, "launches": launches}))
    return 0


# The legacy surfaces (the last slice of the port) at full width, in a child
# of this file (--legacy) beside scale_out: EncoderUNetModel at its JAX
# defaults with the attention pool on a [4, 4, 64, 64] latent (the
# flagship's latent size), a NoisyLatentClassifier train step at that width,
# the lidar VQModel at its class defaults on 32-beam range images, and the
# text towers at ViT-L/14's text width and BERTEmbedder's defaults.
LEGACY_LATENT = (4, 4, 64, 64)
LEGACY_CLASSES = 10
LEGACY_VQ_INPUT = (4, 1, 32, 1024)  # nuScenes' 32 beams, 1024 azimuth bins
LEGACY_TEXT_BATCH, LEGACY_TEXT_TOKENS = 4, 77
LEGACY_TEXT_LENGTHS = (77, 51, 17, 3)  # BERT's key-padding mask: kept tokens a row
# card against CPU in fp32 with TF32 off, relative L2 (the VQ latent and
# decode, the text towers' hidden states); each has a TF32-on control that
# must miss it
LEGACY_REL_L2 = 1e-5
# code indices are gated where the CPU's two best scores differ by more than
# this share of the largest |score|; nearer ties may pick either code
LEGACY_VQ_TIE = 1e-5
LEGACY_TIMEOUT_S = 300  # the child's wait after scale_out
LEGACY_TIMED_STEPS = 3


def legacy_calls():
    """The K1 calls (B, N, H, D) and the K6 calls (B, C, H, W) of one
    EncoderUNetModel forward at its JAX defaults on LEGACY_LATENT, in call
    order: each level's two ResBlocks (two norms each) with a trunk
    attention after each at ds 1, 2 and 4, the flash kernel taking those of
    FLASH_MIN_SEQ tokens or more; then the middle block's two ResBlocks."""
    from mobi_tpu_torch.ops.attention import FLASH_MIN_SEQ

    b, _, hh, ww = LEGACY_LATENT
    flash, norm = [], []
    ch, ds = 320, 1
    for level, mult in enumerate((1, 2, 4, 4)):
        h, w = hh // ds, ww // ds
        for _ in range(2):
            norm += [(b, ch, h, w), (b, 320 * mult, h, w)]
            ch = 320 * mult
            if ds in (4, 2, 1) and h * w >= FLASH_MIN_SEQ:
                flash.append((b, h * w, 8, ch // 8))
        ds *= 2 if level < 3 else 1
    norm += [(b, ch, hh // ds, ww // ds)] * 4
    return flash, norm


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def phase_legacy_encoder(smi: str):
    """EncoderUNetModel (in 4, 320, (1, 2, 4, 4), res 2, attention at ds
    (4, 2, 1), 8 heads, out 1000), attention pool, seeded weights, on a
    seeded LEGACY_LATENT: fp32 and bf16 forwards with the kernels against
    the same model with every attention plain (FP32_UNET_REL_L2,
    UNET_REL_L2), K1 four a forward; the fp32 forward built under
    MOBI_FUSED_GN=1 against the unfused one, K6 twenty a forward (the ten
    ResBlocks' two norms each) beside K1's four; the calls' shapes those of
    legacy_calls. Returns (launches by path, the K1 calls (B, N, H, D) of a
    forward, the K6 calls (B, C, H, W))."""
    import torch

    from mobi_tpu_torch.models import layers
    from mobi_tpu_torch.models.unet import EncoderUNetModel
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.ops import attention as tattn

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(LEGACY_LATENT, generator=g, device=dev)
    t = torch.randint(0, 1000, (LEGACY_LATENT[0],), generator=g, device=dev)
    with torch.device(dev):
        fp32 = EncoderUNetModel(pool="attention", fused_gn=False).init_random_(SEED)
        bf16 = EncoderUNetModel(pool="attention", fused_gn=False, dtype=torch.bfloat16)
        old = os.environ.get("MOBI_FUSED_GN")
        os.environ["MOBI_FUSED_GN"] = "1"  # the JAX package's switch, read at construction
        try:
            fused = EncoderUNetModel(pool="attention")
        finally:
            if old is None:
                del os.environ["MOBI_FUSED_GN"]
            else:
                os.environ["MOBI_FUSED_GN"] = old
    bf16.load_state_dict(fp32.state_dict())
    fused.load_state_dict(fp32.state_dict())
    flash_calls, norm_calls = [], []
    flash, norm = tattn.flash_attention, layers.fused_groupnorm_silu

    def forward(model, backend):
        for m in attention_targets(model, backend):
            m.attn_backend = backend
        _build.reset_launches()
        with torch.no_grad():
            y = model(x, t)
        torch.cuda.synchronize()
        return y.float(), dict(_build.launches)

    rows, launches = {}, {}
    for name, model, tol in (("fp32", fp32, FP32_UNET_REL_L2), ("bf16", bf16, UNET_REL_L2)):
        ref, plain_launches = forward(model, "xla")
        tattn.flash_attention = lambda q, k, v: flash_calls.append(tuple(q.shape)) or flash(q, k, v)
        try:
            got, counted = forward(model, "auto")
        finally:
            tattn.flash_attention = flash
        with torch.no_grad():
            ms = cuda_ms(lambda: model(x, t), 3, warmup=1)
        rows[name] = {"rel_l2": _rel(got, ref), "tolerance": tol, "finite": bool(torch.isfinite(got).all()),
                      "launches": {k: v for k, v in counted.items() if v}, "forward_ms": ms,
                      "plain_launches": {k: v for k, v in plain_launches.items() if v}}
        launches[f"encoder_unet_forward_{name}"] = counted
        if any(plain_launches.values()):
            raise AssertionError(f"legacy_encoder_unet {name}: the plain attention launched {plain_launches}")
        if name == "fp32":
            unfused = got
    layers.fused_groupnorm_silu = lambda *a: norm_calls.append(tuple(a[0].shape)) or norm(*a)
    try:
        got, counted = forward(fused, "auto")
    finally:
        layers.fused_groupnorm_silu = norm
    with torch.no_grad():
        ms = cuda_ms(lambda: fused(x, t), 3, warmup=1)
    rows["fused_gn_fp32"] = {"rel_l2": _rel(got, unfused), "tolerance": FP32_UNET_REL_L2,
                             "finite": bool(torch.isfinite(got).all()),
                             "launches": {k: v for k, v in counted.items() if v}, "forward_ms": ms}
    launches["encoder_unet_forward_fused_gn_fp32"] = counted
    flash_calls = flash_calls[:len(flash_calls) // 2]  # both dtypes make the same calls
    want = {"fp32": launch_counts(flash_fwd=4), "bf16": launch_counts(flash_fwd=4),
            "fused_gn_fp32": launch_counts(flash_fwd=4, gn_silu=20)}
    line = {"phase": "legacy_encoder_unet", "latent": list(LEGACY_LATENT), "pool": "attention",
            "parameters": sum(p.numel() for p in fp32.parameters()), "rows": rows,
            "flash_calls_b_n_h_d": [list(c) for c in flash_calls], "norm_calls_bchw": [list(c) for c in norm_calls],
            "phase_s": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    bad = [n for n, r in rows.items() if not (r["finite"] and r["rel_l2"] <= r["tolerance"])
           or launches[f"encoder_unet_forward_{n}"] != want[n]]
    if (flash_calls, norm_calls) != legacy_calls():  # the shapes the parent times the kernels at
        bad.append("calls")
    if bad:
        raise AssertionError(f"legacy_encoder_unet: {bad}: {json.dumps(line)}")
    del fp32, bf16, fused
    torch.cuda.empty_cache()
    return launches, flash_calls, norm_calls


def phase_legacy_classifier(smi: str):
    """NoisyLatentClassifier(num_classes=LEGACY_CLASSES, model_channels=320,
    channel_mult=(1, 2, 4, 4), attention_resolutions=(4, 2, 1),
    pool="attention"), fp32, every layer seeded, batch 4 at the 64 x 64
    latent, t and noise injected: the gradients of one loss with the kernels
    (K3 forward, K4 and K5 backward) against the plain attention's autograd
    backward within FP32_GRAD_REL_L2, K3, K4 and K5 four each; then
    LEGACY_TIMED_STEPS optimizer steps (optax's Adam), their walls and peak
    memory. Returns the launches of the counted loss and of one step."""
    import torch

    from mobi_tpu_torch.models.classifier import NoisyLatentClassifier, make_classifier_train_step
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.training import AdamWLowMu

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    clf = NoisyLatentClassifier(num_classes=LEGACY_CLASSES, model_channels=320, channel_mult=(1, 2, 4, 4),
                                attention_resolutions=(4, 2, 1), pool="attention", device=dev, seed=SEED)
    clf.model.init_random_(SEED)  # every layer drawn: JAX's init leaves the ResBlocks' output convs at zero
    b = LEGACY_LATENT[0]
    z0 = torch.randn(LEGACY_LATENT, generator=g, device=dev)
    labels = torch.randint(0, LEGACY_CLASSES, (b,), generator=g, device=dev)
    t = torch.randint(0, clf.num_timesteps, (b,), generator=g, device=dev)
    noise = torch.randn(LEGACY_LATENT, generator=g, device=dev)

    def grads(backend):
        for m in attention_targets(clf.model, backend):
            m.attn_backend = backend
        clf.zero_grad(set_to_none=True)
        _build.reset_launches()
        loss, metrics = clf.loss(z0, labels, t=t, noise=noise)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad.detach().clone() for n, p in clf.named_parameters()}, dict(_build.launches)

    torch.cuda.reset_peak_memory_stats()
    ref_loss, ref, _ = grads("xla")
    plain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    loss, got, counted = grads("auto")
    kernel_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    num = math.sqrt(sum(float((got[n] - ref[n]).pow(2).sum()) for n in ref))
    den = math.sqrt(sum(float(ref[n].pow(2).sum()) for n in ref))
    worst = max(((n, float((got[n] - ref[n]).norm() / ref[n].norm())) for n in ref if float(ref[n].norm()) > 0),
                key=lambda kv: kv[1])
    del got, ref
    clf.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    step = make_classifier_train_step(clf, AdamWLowMu(clf.parameters(), 1e-4, torch.float32, weight_decay=0.0))
    walls, step_launches = [], None
    torch.cuda.reset_peak_memory_stats()
    for i in range(LEGACY_TIMED_STEPS + 1):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(z0, labels, t=t, noise=noise)
        torch.cuda.synchronize()
        if i:
            walls.append(time.perf_counter() - t0)
        step_launches = dict(_build.launches)
    line = {"phase": "legacy_classifier", "latent": list(LEGACY_LATENT), "classes": LEGACY_CLASSES,
            "parameters": sum(p.numel() for p in clf.parameters()), "loss": loss, "loss_plain": ref_loss,
            "grad_rel_l2": num / den, "tolerance": FP32_GRAD_REL_L2, "worst_tensor": worst,
            "launches": {k: v for k, v in counted.items() if v},
            "step_launches": {k: v for k, v in step_launches.items() if v},
            "step_wall_s": walls, "step_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "loss_peak_gib": {"kernels": kernel_peak, "plain": plain_peak},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "phase_s": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    want = launch_counts(flash_fwd_lse=4, flash_bwd_dq=4, flash_bwd_dkv=4)
    if not (math.isfinite(loss) and num / den <= FP32_GRAD_REL_L2 and counted == want and step_launches == want
            and all(math.isfinite(v) for v in line["metrics"].values())):
        raise AssertionError(f"legacy_classifier: {json.dumps(line)}")
    del clf, step
    torch.cuda.empty_cache()
    return {"classifier_loss": counted, "classifier_step": step_launches}


def _tf32(fn):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def phase_legacy_vq(smi: str):
    """VQModel at its class defaults (ch 64, mult (1, 2, 4), strides ((1, 2),
    (2, 2)), 2 res blocks, z 8, 8192 codes of 8) on a seeded
    LEGACY_VQ_INPUT range image, fp32, card against the CPU with TF32 off:
    the pre-quantization latent within LEGACY_REL_L2 (a TF32-on control must
    miss it); the code indices equal wherever the CPU's two best scores
    differ by more than LEGACY_VQ_TIE of the largest |score| (the share of
    nearer ties printed); the decode of the CPU's quantized latent within
    LEGACY_REL_L2. No kernel lies on this path."""
    import torch

    from mobi_tpu_torch.models.lidar_vq import VQModel
    from mobi_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    card = VQModel(device="cuda", seed=SEED)
    cpu = copy.deepcopy(card).cpu()
    x = torch.rand(LEGACY_VQ_INPUT, generator=torch.Generator().manual_seed(SEED)) * 2 - 1
    xc = x.cuda()
    _build.reset_launches()
    with torch.no_grad():
        h_cpu = cpu.quant_conv(cpu.encoder(x))
        h = card.quant_conv(card.encoder(xc))
        torch.cuda.synchronize()
        h_tf32 = _tf32(lambda: card.quant_conv(card.encoder(xc)))
        scores = cpu.quantize.scores(h_cpu)
        top, top_idx = scores.topk(2, dim=-1)
        clear = (top[:, 0] - top[:, 1]) > LEGACY_VQ_TIE * scores.abs().max()
        idx = card.quantize(h)[2].flatten().cpu()
        q_cpu, loss_cpu, _ = cpu.quantize(h_cpu)
        dec_cpu = cpu.decode(q_cpu)
        dec = card.decode(q_cpu.cuda())
        torch.cuda.synchronize()
        enc_ms = cuda_ms(lambda: card.quant_conv(card.encoder(xc)), 3, warmup=1)
        dec_ms = cuda_ms(lambda: card.decode(q_cpu.cuda()), 3, warmup=1)
    launches = dict(_build.launches)
    same = idx == top_idx[:, 0]
    line = {"phase": "legacy_vq", "input": list(LEGACY_VQ_INPUT), "latent": list(h.shape),
            "parameters": sum(p.numel() for p in card.parameters()),
            "latent_rel_l2": _rel(h.cpu(), h_cpu), "tf32_control_latent_rel_l2": _rel(h_tf32.cpu(), h_cpu),
            "tolerance": LEGACY_REL_L2, "codes": int(idx.numel()), "tie_share": float(1 - clear.float().mean()),
            "codes_equal_where_clear": bool(same[clear].all()), "codes_equal_share": float(same.float().mean()),
            "codes_used": int(idx.unique().numel()), "decode_rel_l2": _rel(dec.cpu(), dec_cpu),
            "embed_loss_cpu": float(loss_cpu), "encode_ms": enc_ms, "decode_ms": dec_ms,
            "launches": {k: v for k, v in launches.items() if v},
            "phase_s": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    if not (line["latent_rel_l2"] <= LEGACY_REL_L2 < line["tf32_control_latent_rel_l2"]
            and line["codes_equal_where_clear"] and line["decode_rel_l2"] <= LEGACY_REL_L2
            and bool(torch.isfinite(dec).all()) and not any(launches.values())):
        raise AssertionError(f"legacy_vq: {json.dumps(line)}")
    del card, cpu
    torch.cuda.empty_cache()
    return {"vq": launches}


def phase_legacy_text(smi: str):
    """CLIPTextTower at ViT-L/14's text width (768, 12 layers, 12 heads, 77
    tokens, vocab 49408: the model ClassEmbedder's table comes from) and
    BERTEmbedder at its defaults (1280, 32 layers, vocab 30522, 77 tokens)
    with a key-padding mask (LEGACY_TEXT_LENGTHS), seeded weights and ids,
    card against the CPU in fp32: each within LEGACY_REL_L2 with TF32 off,
    a TF32-on control that must miss it. No kernel lies on these paths."""
    import torch

    from mobi_tpu_torch.models.clip import CLIPTextTower
    from mobi_tpu_torch.models.text_transformer import BERTEmbedder
    from mobi_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 2)
    b, n = LEGACY_TEXT_BATCH, LEGACY_TEXT_TOKENS
    mask = torch.arange(n)[None] < torch.tensor(LEGACY_TEXT_LENGTHS)[:, None]
    towers = {"clip_text": (lambda dev, seed: CLIPTextTower(width=768, heads=12, device=dev, seed=seed), 49408, False),
              "bert": (lambda dev, seed: BERTEmbedder(device=dev, seed=seed), 30522, True)}  # ids' vocab, masked
    rows, launches = {}, {}
    for name, (build, vocab, masked) in towers.items():
        card = build("cuda", SEED)
        cpu = copy.deepcopy(card).cpu()
        ids = torch.randint(0, vocab, (b, n), generator=gen)
        args = (ids, mask) if masked else (ids,)
        _build.reset_launches()
        with torch.no_grad():
            want = cpu(*args)
            got = card(*(a.cuda() for a in args))
            torch.cuda.synchronize()
            ctl = _tf32(lambda: card(*(a.cuda() for a in args)))
            ms = cuda_ms(lambda: card(*(a.cuda() for a in args)), 3, warmup=1)
        launches[name] = dict(_build.launches)
        rows[name] = {"rel_l2": _rel(got.cpu(), want), "tf32_control_rel_l2": _rel(ctl.cpu(), want),
                      "finite": bool(torch.isfinite(got).all()), "shape": list(got.shape), "forward_ms": ms,
                      "parameters": sum(p.numel() for p in card.parameters()),
                      "launches": {k: v for k, v in launches[name].items() if v}}
        del card, cpu, got, ctl
        torch.cuda.empty_cache()
    line = {"phase": "legacy_text", "batch": b, "tokens": n, "bert_lengths": list(LEGACY_TEXT_LENGTHS),
            "tolerance": LEGACY_REL_L2, "rows": rows, "phase_s": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    if not all(r["finite"] and r["rel_l2"] <= LEGACY_REL_L2 < r["tf32_control_rel_l2"] and not r["launches"]
               for r in rows.values()):
        raise AssertionError(f"legacy_text: {json.dumps(line)}")
    return launches


def legacy_kernel_times(flash_calls, norm_calls):
    """Each kernel at the legacy path's shapes (legacy_calls) against its
    plain version, with times, the library's and the bound, timed in the
    parent's kernel phase on an otherwise idle card: K1 at the EncoderUNet
    forward's calls in bf16 and fp32, K3-K5 in fp32 at the classifier
    step's, K6 in fp32 at the forward's twenty norms; each summed over its
    calls. Returns {kernel: {dtype: sums}}."""
    import torch
    import torch.nn.functional as F

    from mobi_tpu_torch.ops import flash_attention as fa
    from mobi_tpu_torch.ops import fused_norm as fn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    cases = {(b, n, n, h, d): "main_path" for b, n, h, d in sorted(set(flash_calls))}
    out = {}
    for dtype, fp32 in (("bfloat16", False), ("float32", True)):
        _, per = flash_rows("flash_fwd", fa.flash_fwd, cases, g, dev, getattr(torch, dtype), fp32=fp32)
        out.setdefault("flash_fwd", {})[dtype] = {
            **{k: sum(per[c][k] for c in flash_calls) for k in keys},
            "bound_by": max(per.values(), key=lambda r: r["bound_ms"])["bound_by"],
            "per": f"one EncoderUNet forward ({len(flash_calls)} launches)"}
    rows = phase_train_kernels_fp32(None, 0, calls=flash_calls, head_dims=False)
    for name, rs in rows.items():
        per = {tuple(r["shape_b_nq_nk_h_d"][i] for i in (0, 1, 3, 4)): r for r in rs}
        out[name] = {"float32": {**{k: sum(per[c][k] for c in flash_calls) for k in keys},
                                 "bound_by": max(per.values(), key=lambda r: r["bound_ms"])["bound_by"],
                                 "per": f"one classifier step ({len(flash_calls)} launches)",
                                 "max_abs_err": max(r["max_abs_err"] for r in rs)}}
    per = {}
    for shape in sorted(set(norm_calls)):
        b, c, hh, ww = shape
        x = torch.randn(shape, generator=g, device=dev) * 2.0 + 0.5
        w = torch.rand(c, generator=g, device=dev) + 0.5
        bias = torch.randn(c, generator=g, device=dev)
        got = fn.fused_groupnorm_silu(x, w, bias, 32, 1e-5)
        torch.cuda.synchronize()
        err, ratio = check_close(f"gn_silu fp32 {shape}", got, fn.groupnorm_silu_plain(x, w, bias, 32, 1e-5),
                                 K6_F32_ATOL, K6_F32_RTOL)
        row = {"phase": "kernel", "name": "gn_silu", "dtype": "float32", "shape_bchw": list(shape),
               "case": "legacy", "max_abs_err": err, "err_over_tol": ratio,
               "ms": cuda_ms(lambda: fn.fused_groupnorm_silu(x, w, bias, 32, 1e-5), 20),
               "plain_ms": cuda_ms(lambda: fn.groupnorm_silu_plain(x, w, bias, 32, 1e-5), 5),
               "library_ms": cuda_ms(lambda: F.silu(F.group_norm(x, 32, w, bias, 1e-5)), 20)}
        row["bound_ms"], row["bound_by"] = bound(0, 0, 2 * 4 * x.numel())
        emit(row)
        per[shape] = row
    out["gn_silu"] = {"float32": {**{k: sum(per[c][k] for c in norm_calls) for k in keys}, "bound_by": "bytes",
                                  "per": f"one EncoderUNet forward, MOBI_FUSED_GN=1 ({len(norm_calls)} launches)",
                                  "max_abs_err": max(r["max_abs_err"] for r in per.values())}}
    torch.cuda.empty_cache()
    return out


def legacy_child(out_path: str) -> int:
    """python3 chip_smoke.py --legacy OUT: beside scale_out, the legacy
    surfaces' phases in order (legacy_encoder_unet, legacy_classifier,
    legacy_vq, legacy_text); their kernels' times come from the parent
    (legacy_kernel_times). Writes to OUT as JSON the phases' lines and each
    path's K1-K6 launches. A failed gate raises (exit 1)."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mobi_tpu_torch.ops import _build

    _build.library()  # the parent built it
    smi = nvidia_smi_line()
    launches, _, _ = phase_legacy_encoder(smi)
    launches.update(phase_legacy_classifier(smi))
    launches.update(phase_legacy_vq(smi))
    launches.update(phase_legacy_text(smi))
    Path(out_path).write_text(json.dumps({"lines": _EMITTED, "launches": launches}))
    return 0


def legacy_start(root: Path):
    """Start legacy_child beside scale_out -> (the child, its log)."""
    root.mkdir(parents=True, exist_ok=True)
    log = open(root / "legacy.log", "w")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--legacy", str(root / "legacy.json")],
                            stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT), env=child_env("legacy"))
    return proc, log


def legacy_finish(root: Path, proc, log, timeout_s: float = LEGACY_TIMEOUT_S):
    """Wait for legacy_child (ended if it overruns), print its lines again
    (`ran_beside`: scale_out) -> each path's launches."""
    try:
        proc.wait(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    if proc.returncode != 0:
        raise AssertionError(f"legacy child (exit {proc.returncode}): {(root / 'legacy.log').read_text()[-3000:]}")
    out = json.loads((root / "legacy.json").read_text())
    for line in out["lines"]:
        emit({**line, "ran_beside": "scale_out", "child_t_s": line["t_s"]})
    shutil.rmtree(root, ignore_errors=True)
    return out["launches"]


def main() -> int:
    if sys.argv[1:2] in (["--scale-out-rank"], ["--oracle-tiny"], ["--detection-plan"], ["--detection"], ["--legacy"]):
        if not (ROOT / "mobi_tpu_torch" / "csrc").is_dir():
            print(f"chip_smoke: the mobi_tpu_torch package is not beside {__file__}", file=sys.stderr)
            return 2
        if sys.argv[1] == "--legacy":
            return legacy_child(sys.argv[2])
        if sys.argv[1] == "--oracle-tiny":
            return oracle_tiny_child(sys.argv[2])
        if sys.argv[1] == "--detection-plan":
            return detection_plan_child(sys.argv[2])
        if sys.argv[1] == "--detection":
            return detection_child(sys.argv[2])
        return scale_out_rank(sys.argv[2], int(sys.argv[3]))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke needs one", file=sys.stderr)
        return 2
    if not (ROOT / "mobi_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the mobi_tpu_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    # fp32 matmuls and convs in full fp32 (cuDNN would default convs to TF32);
    # the flagship runs in bf16, where neither applies
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": {"matmul": False, "cudnn": False}})

    from mobi_tpu_torch.models.diffusion import MobiConfig, MobiDiffusion
    from mobi_tpu_torch.ops import _build

    t0 = time.perf_counter()
    fresh = not _build.library_path().exists()
    lib_path = _build.build()
    _build.library()
    report = ptxas_report(lib_path.with_suffix(".log")) if fresh else []
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib_path.name,
          "nvcc_seconds": dict(_build.compile_seconds), "ptxas": report})
    if sys.argv[1:] == ["--scale-out-control"]:
        root = ROOT / "build" / "scale_out_control"
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
        scale_out_train(root, control=True)
        shutil.rmtree(root, ignore_errors=True)
        return 0

    cfg = MobiConfig(dtype=torch.bfloat16)
    k1, k2, k6 = phase_kernels(cfg, 4 * PAIRS)
    k3, k4, k5 = phase_train_kernels(cfg, 2 * TRAIN_PAIRS)
    fp32_rows = phase_train_kernels_fp32(cfg, 2 * TRAIN_PAIRS)
    legacy_times = legacy_kernel_times(*legacy_calls())
    train_calls = train_flash_calls(cfg, 2 * TRAIN_PAIRS)
    for kern in (k3, k4, k5):
        kern["fp32"] = fp32_rows[kern["name"]]
        by_shape = {tuple(r["shape_b_nq_nk_h_d"][i] for i in (0, 1, 3, 4)): r for r in kern["fp32"]}
        kern["fp32_per_step"] = {key: sum(by_shape[c][key] for c in train_calls)
                                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = MobiDiffusion(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    emit({"phase": "model", "seconds": time.perf_counter() - t0,
          "parameters": sum(p.numel() for p in model.parameters())})
    counts, counts_fused = phase_flagship(model, smi)
    phase_switches(model)
    del model
    torch.cuda.empty_cache()

    served = phase_serve(smi)
    tav_counts = phase_plms_tav(*served)
    bench = phase_test_bench(served[0], smi)
    evaluation = phase_eval(served[0], bench["db"], smi)
    del served
    torch.cuda.empty_cache()
    phase_fp32()
    camera_only = phase_camera_only(smi)

    model, tx, train_counts = phase_train(cfg, smi)
    phase_train_switches(model, tx)
    remat = phase_remat(model, tx)
    del model, tx
    torch.cuda.empty_cache()
    oracle = phase_oracle(smi)
    torch.cuda.empty_cache()
    cli = phase_train_cli(smi)
    torch.cuda.empty_cache()
    range_vae = phase_range_vae(smi, cli["final_checkpoint"])
    torch.cuda.empty_cache()
    tiny_root = ROOT / "build" / "oracle_tiny"
    shutil.rmtree(tiny_root, ignore_errors=True)
    tiny_proc, tiny_log = oracle_tiny_start(tiny_root)
    plan_root = ROOT / "build" / "detection_plan"
    shutil.rmtree(plan_root, ignore_errors=True)
    plan_proc, plan_log = detection_plan_start(plan_root)
    det_root = ROOT / "build" / "det_train"
    shutil.rmtree(det_root, ignore_errors=True)
    shutil.rmtree(ROOT / "build" / "detection", ignore_errors=True)
    det_proc, det_log = detection_start(det_root)
    life_root = ROOT / "build" / "lifecycle"
    shutil.rmtree(life_root, ignore_errors=True)
    life_proc, life_log = lifecycle_start(life_root, cli["final_checkpoint"])
    legacy_root = ROOT / "build" / "legacy"
    shutil.rmtree(legacy_root, ignore_errors=True)
    legacy_proc, legacy_log = legacy_start(legacy_root)
    try:
        scale_out = phase_scale_out(smi, bench)
    except BaseException:
        for proc, log in ((tiny_proc, tiny_log), (plan_proc, plan_log), (det_proc, det_log),
                          (life_proc, life_log), (legacy_proc, legacy_log)):
            proc.kill()
            proc.wait()
            log.close()
        raise
    _, tiny_launches = oracle_tiny_finish(tiny_root, tiny_proc, tiny_log, ORACLE_TINY_TIMEOUT_S)
    detection_launches, det_train_launches, head_launches = detection_finish(det_root, det_proc, det_log, smi)
    lifecycle_launches = lifecycle_finish(life_root, life_proc, life_log, smi)
    legacy_launches = legacy_finish(legacy_root, legacy_proc, legacy_log)
    shutil.rmtree(Path(cli["final_checkpoint"]).parent, ignore_errors=True)
    phase_detection_dense(det_dense_models(), plan_proc, plan_log, plan_root, smi)
    shutil.rmtree(ROOT / "build" / "detection", ignore_errors=True)
    oracle.update({f"tiny_{k}": v for k, v in tiny_launches.items()})

    k1["launches"], k1["path"] = counts["flash_fwd"], "flagship DDIM batch, defaults"
    k1["test_bench_launches_per_batch"] = bench["launches_per_batch"]["flash_fwd"]
    k2["test_bench_launches_per_batch"] = bench["switches_launches_per_batch"]["flash_fwd_tav"]
    k6["test_bench_launches_per_batch"] = bench["switches_launches_per_batch"]["gn_silu"]
    k2["launches"] = tav_counts["flash_fwd_tav"]
    k2["path"] = f"one PLMS-{STEPS} batch of the served model ({SERVE_PAIRS} pairs), K2 switch on"
    k6["launches"], k6["path"] = counts_fused["gn_silu"], "flagship batch, fused GroupNorm + SiLU switch on"
    for kern in (k3, k4, k5):
        kern["launches"] = train_counts[kern["name"]]
        kern["path"] = f"adapter training step, {TRAIN_PAIRS} pairs, the counted step"
    # the learning path's own launches (phase oracle), each path counted alone
    for kern in (k1, k3, k4, k5):
        kern["oracle_launches"] = {path: c[kern["name"]] for path, c in oracle.items() if c[kern["name"]]}
    # the training CLI's own launches: its whole run and its resume, and one
    # training step, validation batch and image-log call, each counted alone
    for kern in (k1, k3, k4, k5):
        name = kern["name"]
        kern["train_cli_launches"] = {
            "run": cli["launches_run"].get(name, 0), "resume": cli["launches_resume"].get(name, 0),
            **{part: cli[f"launches_per_{part}"][name] for part in ("train_step", "val_batch", "image_log")}}
        kern["remat_launches"] = {mode: row["launches"][name] for mode, row in remat.items()}
    # the range_vae phase's launches (no kernel lies on its path: 0)
    for kern in (k1, k2, k3, k4, k5, k6):
        kern["range_vae_launches"] = sum(r["launches"].get(kern["name"], 0) for r in range_vae["runs"].values())
    # the eval phase's launches: K1 in each mode's UNet forwards, the scorers none
    for kern in (k1, k2, k3, k4, k5, k6):
        kern["eval_launches"] = evaluation["launches"].get(kern["name"], 0)
    k1["eval_launches_per_mode"] = evaluation["launches_per_mode"]
    # the detection phase's launches (no kernel lies on its path: 0), and the
    # detector training CLI's (the det_train child: 0)
    for kern in (k1, k2, k3, k4, k5, k6):
        kern["detection_launches"] = detection_launches.get(kern["name"], 0)
        kern["det_train_launches"] = det_train_launches.get(kern["name"], 0)
    # the camera-only model's DDIM batch and whole-UNet training loss; the
    # CenterPoint head and the point ops (0); each lifecycle phase's
    # (the inpaint's K1, 0 in the detection eval)
    for kern in (k1, k2, k3, k4, k5, k6):
        name = kern["name"]
        kern["camera_only_launches"] = {part: c.get(name, 0) for part, c in camera_only.items()}
        kern["centerpoint_launches"] = head_launches["centerpoint"].get(name, 0)
        kern["point_ops_launches"] = head_launches["point_ops"].get(name, 0)
        kern["lifecycle_launches"] = {phase: c.get(name, 0) for phase, c in lifecycle_launches.items()}
    # the legacy surfaces' launches, each path counted alone (K1 4 an
    # EncoderUNet forward, K6 20 with the fused norm, K3-K5 4 a classifier
    # loss and step, 0 on the VQ and text paths), and each kernel's times
    # at their shapes from the kernel phase (the card idle)
    for kern in (k1, k2, k3, k4, k5, k6):
        kern["legacy_launches"] = {path: c.get(kern["name"], 0) for path, c in legacy_launches.items()}
        if kern["name"] in legacy_times:
            kern["legacy"] = legacy_times[kern["name"]]
    # the scale-out cases' launches, each rank's own (kernels off the path: 0)
    for kern in (k1, k2, k3, k4, k5, k6):
        name = kern["name"]
        kern["scale_out_launches"] = {case: {who: c.get(name, 0) for who, c in per.items()}
                                      for case, per in scale_out.items()}
    for kern in (k1, k2, k3, k4, k5):  # the off-main-path head dims' instantiations
        for row in kern["head_dims"] + [r for r in kern["fp32"] if r.get("case") == "head_dim"]:
            row.update(ptxas_for(report, kern["name"], row["dtype"], row["shape_b_nq_nk_h_d"][4]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "err_over_tol",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "per", "path")
    emit({"kernels": [{**{k: kern[k] for k in keys},
                       **{k: kern[k] for k in ("oracle_launches", "test_bench_launches_per_batch",
                                               "train_cli_launches", "remat_launches", "range_vae_launches",
                                               "eval_launches", "eval_launches_per_mode", "detection_launches",
                                               "det_train_launches", "camera_only_launches",
                                               "centerpoint_launches", "point_ops_launches", "lifecycle_launches",
                                               "legacy_launches", "legacy", "scale_out_launches",
                                               "head_dims",
                                               "spans", "fp32", "fp32_per_step",
                                               "plain", "max_abs_diff_vs_flash_fwd", "host_us_per_call")
                          if k in kern}}
                      for kern in (k1, k2, k3, k4, k5, k6)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
