#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (multi_modal_csi_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit, torch and CUDA versions; build the
   six kernel sources (attention forward K1, its backward K2, the CSI
   amplitude-phase pass K5, MViT's low-rank-bias attention K3 and its
   backward K4, two kernels, and int8 serving's tile product P1) from
   csrc/ with one nvcc each, started together, timed, with ptxas's line
   (registers, spills, static shared memory) for each kernel;
2. K1 against its plain PyTorch version on the card, f32 and bf16 (the
   two bodies of csrc/tc_attention.cuh: f32 as 3xTF32 on the tensor
   cores), at THAT's left (256, 150, 10, 27) and right (256, 270, 10, 15)
   shapes, THAT_ENCODER's right (256, 270, 10, 27), a ragged
   (3, 64, 10, 15) case, a cross case (Nq 128, Nk 420, 6 heads of 45) and
   2048 keys of D = 27, and in f32 THAT's three shapes at the training
   batch of 16; f32 the same bits twice and the kernel's and plain
   version's distance from float64 at THAT_ENCODER's right shape at 16;
   then per-launch times with CUDA events in the order plain, kernel,
   kernel, plain, beside scaled_dot_product_attention's time on the same
   inputs (a yardstick the port never calls) and the card's bound for the
   same work (f32: at the f32 peak and as 3xTF32); in f32 also each call's
   device time from torch.profiler (kernel, plain, SDPA's own kernels),
   summed per THAT and THAT_ENCODER training step; a head dim of 129 must
   raise in both dtypes, and 4096 keys of D = 27 launch in f32;
3. K2 against its plain version, f32 and bf16, at THAT's and
   THAT_ENCODER's training shapes at batch 16 (and THAT's at 256), a
   ragged (3, 70, 10, 15) case with 97 keys and a cross case
   (4, 128, 6, 45) with 300 keys; in both dtypes (the query pass and the
   dK/dV pass of csrc/tc_attention_bwd.cuh) the same bits twice, and at
   THAT_ENCODER's right shape each gradient's distance from float64 for
   the kernel and the plain version (bf16: the kernel's at most 2x the
   plain version's); per-launch times as for K1 with each pass's device
   time from torch.profiler, per THAT and THAT_ENCODER training step in
   each dtype, beside the backward of scaled_dot_product_attention on the
   same inputs and the bounds (f32: at the f32 peak and as 3xTF32); four
   shapes where K2 bf16 copies rows in other widths (8- and 16-byte
   pieces shifted, a span of 128, an odd row stride) within tolerance and
   the same bits twice; a head dim of 129 must raise in both dtypes;
4. K5 against its plain version at one WiMANS trace (3000, 270), a ragged
   (2999, 270) one, a batch of 8 traces and a buffer not 16-byte aligned:
   the amplitude bit for bit, the phase within 4 ulp; the device time
   per call from torch.profiler (CUDA events around back-to-back calls
   measure the host's call rate at one trace) beside the plain version's,
   torch.hypot with torch.atan2, and the bound;
4b. K3 against its plain version at MViT's seven block shapes of a
   (2, 45, 224, 224, 3) forward and the JAX test's odd shapes, f32 and
   bf16, with and without the bias: out within 2e-5 (f32) or 2^-7 of the
   largest |out| (bf16), the row LSE within 1e-5 relative; per-call times
   at the block shapes in bf16 beside the plain version's,
   scaled_dot_product_attention's with r @ s as its mask, and the bound,
   summed per MViT-v1 and v2 forward (the bf16 kernel is the tensor-core
   kernel of csrc/tc_attention.cuh, its bias a 3xTF32 product), and the
   same in f32 at the training blocks 0-2, summed per training step, with
   the f32 bound at the f32 peak and as 3xTF32 (the f32 kernel is that
   file's f32 body: QK^T and P.V as 3xTF32, the bias as the plain
   version's FMA chain, which must be the plain version's r @ s bit for
   bit at the training blocks), and SDPA's f32 kernels named from a
   profile at block 0; f32 also at two shapes where the f32 launcher
   takes its other configuration (4 warps over 64 rows, key tiles of 32);
   at the seven f32 block shapes both the kernel's and the plain
   version's distance from the same function in float64; a head dim of
   160 or a bias of 129 factor columns must be refused in either dtype;
4c. K4 (dQ/dR and dK/dV/dS kernels) against its plain version at MViT's
   three training block shapes of a (2, 45, 224, 224, 3) step and the JAX
   test's odd shapes, f32 and bf16, with and without the bias, both fed
   K3's out and LSE: each gradient within 5e-5 (f32) or 2^-7 (bf16) of
   its largest magnitude; in f32 (both kernels are bodies of
   csrc/tc_attention_bwd.cuh) at the training shapes every gradient's
   distance from float64 for the kernel and the plain version, both
   kernels the same bits twice at block 1 with the bias; in both dtypes
   per-call times of each kernel beside its plain part's, the backward of
   scaled_dot_product_attention with r @ s as a mask of the dtype, and the
   bounds, summed per MViT-v1 and v2 training step; a head dim of 160,
   and in f32 a bias of 130 factor columns, must be refused;
4d. P1 (kernels/int8_matmul.py), both instantiations, against their
   plain versions at P1's own tile (256, 272) x (272, 424), every product
   of DETR's and THAT_ENCODER's bs256 int8 forwards and odd shapes (1 x 1
   x 1, 17 x 33 x 65, K mod 32 = 14, K = 27,000, grouped): s8 exactly,
   bf16 within K 2^-23 sum |a b| of the exact product; per shape the
   kernel's and the plain version's times, torch._int_mm's (K and N
   zero-padded to multiples of 8, as cuBLASLt needs) or bf16
   torch.matmul's (yardsticks the port never calls), and the bound; a K
   whose int32 sum could overflow must raise; then the fused path (the
   prologue quantize_columns and quantized_product with its epilogue,
   through core/quantize.py) at the odd shapes as Linears or grouped
   convs, w8a8 and w8, with a bias: the prologue torch.equal to its plain
   version on the card, the s8 output torch.equal to the eager chain, the
   bf16 output within accumulation_bound's bound plus the
   epilogue's roundings, with times beside the yardstick (_int_mm or
   matmul plus the eager epilogue) and the bound; a bf16 operand whose
   rows no 4-byte copy divides must be refused, raising; the implicit
   conv (quantized_conv3d) at CONV3D_ODD, w8a8 and w8, held likewise
   (int8 codes torch.equal), and codes off 16-byte alignment refused,
   raising; also every
   product of CNN-1D's w8a8 and MLP's w8 forwards, and MLP's layer_0 as
   it runs, bf16 (256, 810000) x int8 (256, 810000) through
   quantized_product, within the long-K accumulation bound (LONG_K_LAMBDA
   2^-24 sqrt(K) sum |a b|) of the exact product, which must refuse an
   all-zero output and the output without one split of K or one stage,
   beside bf16_matmul_f32_reference with its times, bf16 torch.matmul's,
   the bound and the splits of K that split_count picks for its 6 output
   tiles;
4e. K1 and K2 at the largest shapes their fit predicates admit, each
   instantiation: K2 in both dtypes at 64 tokens of a head of 128 (a head
   of 129: refused with ValueError) and at 640 tokens of D = 27 against
   its plain version, K1 in both dtypes at 4096 keys of a head of 128 (a
   head of 129: refused), K3 in both dtypes at a bias of 128 factor
   columns and a head of 128 (129 of either: refused);
5. preprocessing on the card (cli/preprocess_csi.py, the default device):
   4 synthetic WiMANS .mat traces of 3000 packets to amplitude and phase
   files, exactly 4 K5 launches, seconds per trace by stage (.mat parse,
   host-to-card copy, kernel, fetch, save); the files against the host
   path (--device cpu): amplitude within 2.4e-7 relative, phase within 4
   ulp;
6. THAT serving at full width, bf16, batch 256: seeded weights, ragged
   requests of 256, 100 and 300 seeded windows, exactly 5 K1 launches per
   batch forward; windows/s from host memory, and with the requests
   already on the card; 5 batch forwards under torch.profiler for the
   device time per forward, the device's busy share, the kernels with
   the most device time and K1's share; then the same weights at f32
   (PyTorch's default flags, batch 4)
   against the CPU, where the plain versions run; the same for DETR at
   the flagship configuration, with no kernel launch, and for
   THAT_ENCODER, with 5 K1 launches per forward;
6a. the six WiMANS baselines (MLP, CNN-1D, CNN-2D, LSTM, CLSTM, ABLSTM)
   served the same way at full width, bf16, batch 256 (LSTM and ABLSTM,
   whose bf16 step loops make 4,800 and 12,000 launch calls a forward,
   the first request only): no kernel launch, windows/s from host
   memory (since the launcher phase, no rates on the card and no profile:
   BASELINES), and f32 card vs CPU within SERVE_F32_TOL as THAT's, the
   CPU taking the card's side at every leaky-ReLU kink; each phase's wall
   time;
6b. int8 serving of MLP in w8 (--quant auto: 2 bf16 P1 launches a
   forward, no prologue, logits within 0.25 of the bf16 logits' spread)
   and CNN-1D in w8a8 (4 prologue and 4 s8 launches, card vs CPU as
   below; the JAX package has no accuracy bound for it, so its distance
   from bf16 serving is printed), CNN-2D in w8 and w8a8 (stages 1 and 2
   one implicit conv each, after a k = 1 prologue unless a w8 bf16 input
   is read as it is: exact counts from ``int8_conv_launches``),
   then of DETR and THAT_ENCODER in w8a8
   (their QUANT_DEFAULTS),
   bf16, batch 256, calibrated through CSIServer(calib=...) on a seeded
   .npy of 64 windows: exact s8 and bf16 P1 launches by product shape and
   prologue launches in one batch forward (22 + 54 and 52 for DETR; 27 +
   58, 53 and 5 K1 for THAT_ENCODER); every prologue and fused product of
   one forward held and timed as in 4d on the forward's own activations,
   weights and scales (every product shape of the tables); the ragged
   requests, windows/s from host memory and on the card beside bf16
   serving's, a profile with P1's, the prologue's and the remaining
   elementwise kernels' shares (the baselines MLP, CNN-1D and CNN-2D
   from host memory only, no profile); the logits
   against bf16 serving within the JAX package's own bounds; then the
   same int8 weights and scales at f32 on the card against the CPU, with
   the int8 activations that flipped; and cli/serve_csi.py --model DETR
   --quant auto --calib F.npy once;
7. THAT training at full width through ``fit``: seeded (80, 3000, 270)
   training and (32, 3000, 270) validation windows, activity labels,
   batch 16, 2 epochs, augmentation on, f32; in f32 and in bf16 (as fit
   trains with train_dtype="bfloat16") exactly 5 K1 and 5 K2 launches of
   the dtype in one training step, windows trained per second after a
   warm-up step and 5 steps under torch.profiler (K1's and K2's two
   passes' device ms per step and share); then one bf16 epoch (5 bf16 K2
   launches a step);
8. one f32 THAT training step on the card against the CPU (default flags,
   batch 2, augmentation and dropout off, the CPU taking the card's side
   at every leaky-ReLU kink): loss and gradients;
9. DETR's training step at the flagship configuration, batch 16, with the
   Hungarian matching loss and augmentation: finite loss, no kernel
   launch, windows/s;
9b. each WiMANS baseline trained in f32 at batch 16 (no kernel launch in
   a step after a warm-up step, then fit for one epoch; since the launcher
   phase no rate and no profile: BASELINES), and one f32 step of LSTM and
   of CNN-2D on the card
   against the CPU as in 8, with the BatchNorm running statistics too;
10. the experiment path (runners/csi.py::run_experiment) for THAT_ENCODER
   and DETR at full width: a synthetic annotation.csv of 48 windows in one
   environment, an amplitude cache of the 4 traces of phase 5 and 44
   windows of 2500 to 3000 steps, 2 epochs at batch 16, the final test
   pass in bf16; the result JSON read back with the JAX runner's keys;
   THAT_ENCODER's exact K1 (f32 and bf16) and K2 launch counts, none for
   DETR; then MLP (flat windows) and CNN-1D (count_round) for one epoch
   each, with no kernel launch; every run reads its windows through the
   C++ loader (data/native_loader.py, built with g++ from the checkout),
   and THAT_ENCODER's run logs through JSONL MetricWriters, read back: an
   epoch record per epoch equal to fit's history, the repeat's summary and
   the aggregate equal to the result's (these runs with cuDNN's
   deterministic algorithms); then the multi-node launcher
   (jobs/gpu-multinode.sh) for real at one node of one card: its torchrun
   agent (c10d rendezvous on 127.0.0.1) starts one rank in an NCCL group
   that runs cli/run_csi.py --distributed --mesh --set mesh.fsdp=true for
   THAT_ENCODER with the same dataset and config, cuDNN deterministic
   too: exit code 0, the result JSON's keys, every number in it but the
   wall times within LAUNCHER_TOL (0: bit for bit) of the in-process
   THAT_ENCODER result (the differences printed), the phase's seconds and
   whether the run built any library anew;
10a. the ops layer (ops_phase) at full width: the C++ loader against the
   numpy loader on 10's dataset bit for bit, each timed at 8 and 1
   threads; THAT_ENCODER training steps at batch 16: a warm-up step, 3
   steps timed by StepTimer, 3 under utils/profiling.py::trace with
   StepTimer (the written Chrome trace parsed: its K1 f32 kernels and
   K2's two passes equal to the launch counts of those steps), a forward
   and backward under nan_guard (no raise, logits bit-equal to the
   unguarded pass, its cost), a NaN in one input window raising
   FloatingPointError at a named op, and a NaN in the gradient fed to K2
   named at K2's launch (the backward runs on the autograd engine's
   thread); explore's packet_loss_stats and label_distribution on 10's
   dataset, and csi_heatmap raising an ImportError naming matplotlib
   where the machine lacks it (else writing its PNG);
10b. transfer learning from the component files that 10's THAT_ENCODER
   and DETR runs saved (save_model): each restored under feature_encoder
   into the weights of seed 0 (feature extractor and encoder the file's
   bit for bit, the rest the fresh weights); one THAT_ENCODER training
   step with transfer_optimizer (exactly 5 K1 f32 and 5 K2 launches) and
   its profile with K1's and K2's shares; run_experiment under
   feature_encoder (THAT_ENCODER 2 epochs, exact K1 and K2 counts; DETR
   one epoch, no launch) saving its best weights: the result JSON's keys,
   the weights moved, and DETR's frozen feature extractor bit-equal while
   its BatchNorm statistics moved;
10c. run resume: THAT fit at batch 16, f32, with the cosine-warmup
   schedule and a run checkpoint an epoch, 2 epochs; the checkpoint
   restored into a fresh model, Adam and schedule (weights, buffers,
   Adam's step and moments, the schedule's step and learning rate, bit for
   bit); fit with epochs=3 on the same directory trains epoch 2 alone
   (5 K1 f32 and 5 K2 a step);
10d. SSL: run_ssl for one epoch at batch 16 on the seeded windows,
   saving its weights, then cli/ssl_inference.py on the file over 10's
   dataset; no kernel launch; the training rate and a profile of the step
   with the random views; one f32 step with fixed views at batch 8 on the
   card against the CPU (loss, gradients, BatchNorm statistics);
10e. dual_band: one epoch of run_csi_model on (80, 2, 3000, 270) paired
   windows at batch 16, no launch; the f32 forward card vs CPU within
   SERVE_F32_TOL; profiles of the f32 forward and training step;
10f. ST-RF: kernels/spectrogram.py::strf_features on the card against
   the scipy features on the host at (16, 3000, 270) within STRF_REL of
   the largest feature, both times; the ST-RF runner, whose features
   come from strf_features on the card, where sklearn imports, else the
   ImportError naming sklearn;
11. MViT-v1 and MViT-v2 serving at full width (runners/video.py,
   core/serving.py::VideoServer), bf16, batch 2: seeded weights, ragged
   requests of 2, 1 and 3 seeded (45, 224, 224, 3) clips, exactly 16 K3
   launches per batch forward; clips/s from host memory and with the
   clips on the card; 5 forwards under torch.profiler (K3's share); then
   a bf16
   training forward and backward of one batch: exactly 3 K3 and 3 of each
   K4 kernel (blocks 0-2 at the training gate, the eager path after);
11b. MViT-v2 w8 serving at full width, bf16, batch 2 (the hooked set
   discovered with one zero clip): exactly 16 K3 and 67 bf16 P1 launches
   per batch forward, no s8 and no prologue (every product takes its bf16
   activation as it is), the forward's fused calls held as in 6b, clips/s beside bf16 serving's, a profile with the
   shares, the logits against bf16 serving, and the bare P1 held against
   its plain version at each of the forward's product shapes;
12. each variant in f32 at (2, 16, 112, 112, 3) on the card (default flags,
   14 K3 launches) against the CPU, where K3's plain version runs, within
   1e-4 of the largest logit;
13. runners/video.py::evaluate for each variant over a ClipDataset of 5
   seeded cached clips, bf16, chunks of 2, the weights loaded with
   load_video_pretrained from a torchvision-layout .pt the script writes
   at (16, 224, 224): logits against VideoServer's, exactly 48 K3
   launches;
14. MViT-v1 and MViT-v2 training steps at full width (train/loop.py::
   make_train_step, Adam, BCE), f32, batch 2, (45, 224, 224, 3) clips on
   the card: exactly 3 K3 and 3 of each K4 kernel a step; peak memory,
   clips trained/s, 5 steps under torch.profiler; whether a step at the
   JAX CLI's batch 8 fits in the card's memory;
15. one f32 MViT-v2 step at (1, 32, 224, 224, 3) on the card (default flags,
   K3 and K4 at blocks 0-2) against the CPU (the eager path), dropout
   off, the CPU taking the card's pick at every residual max pool: loss
   and gradients;
16. the video experiment path (cli/run_video.py -> run_video_model ->
   fit_video) for MViT-v1 and MViT-v2 in f32 and MViT-v2 in bf16: 10
   cached (45, 224, 224, 3) clips with a synthetic annotation.csv, repeat
   1, one epoch at batch 2, the final test pass in bf16; the result JSON
   read back with the JAX runner's keys; exact K3 and K4 launch counts;
   MViT-v1's run saves through path.save_model, and the file holds
   fit_video's best weights bit for bit and loads into a fresh MViT-v1;
16b. ResNet3D-18, S3D, Swin3D-T and Swin3D-S (models/video/{resnet3d,
   s3d,swin3d}.py) served at their serving batch and dtype (ResNet 64
   (45, 112, 112) clips and S3D 32 (45, 224, 224) in bf16, Swin 2 in f32):
   ragged requests, no launch, clips/s, peak memory, a profile, the f32
   logits at batch 1 against the CPU (Swin at (16, 224, 224)); ResNet and
   S3D in w8a8 (--quant auto, calibrated on 8 seeded clips): the exact
   implicit-conv (int8_conv3d: one a conv of 16 channels or more), P1 s8,
   3-D prologue (int8_quantize_columns3d: the C = 3 stems' chunks) and
   prologue (k = 1 and the Linear) launches of a forward, every prologue,
   fused product and implicit conv of a ResNet and an S3D forward held
   against its plain version bit for bit and timed (S3D: its stem
   temporal conv alone), rates, a profile with the kernels' shares, the
   peak memory beside bf16's, the logits against bf16 serving (ResNet
   within the JAX package's 0.35 of the spread), ResNet's layer1 conv
   against cuDNN's bf16 conv3d and its k = 1 prologue against its byte
   bound, and card vs CPU on the same int8 weights with the card's int8
   codes fed to the CPU; one f32 training step of each at batch 2
   (no launch, peak memory; ResNet and Swin-T also clips trained/s and a
   profile), and one at a
   small clip against the CPU in f32 and float64 with the card's ReLU
   sides and max-pool picks replayed; cli/run_video.py with its default
   model (Swin-T) on the 10 cached clips. CNN-2D's int8 Conv2d (stages 1
   and 2 on the implicit conv) is served in w8 and w8a8 with the other
   baselines (phase 6b);
16c. serving artifacts (core/export.py): card-only artifacts (the hand
   kernels as mmcsi custom ops in the exported program) of THAT bf16 at
   256 windows (K1), DETR w8a8 at 256 (P1 and the prologue), MViT-v2 bf16
   at 2 clips (K3) and ResNet w8a8 at 8 clips (the implicit conv, the
   3-D prologue and P1),
   each exported, saved, reloaded with serve_file and served: the same
   launches a forward as its eager server and logits within 1e-5 of the
   eager server's largest, with the export and load seconds, the size
   beside the weight files it stores and the device ms a forward beside
   the eager server's; a Swin-T f32 card-only artifact at batch 1 run with
   cuDNN's TF32 flag at PyTorch's default against the CPU within 2e-6 of
   the largest logit; a cuda,cpu MLP w8 artifact (the input BatchNorm
   folded, the int8 input contract, f32 activations) on the card, its
   mmcsi ops launching the prologue and P1 as often as the eager w8 server
   and its logits within 1e-5 of that server's, and against the same
   artifact on the CPU within 2e-3; before it, layer_0's 810,000-wide f32
   row through the prologue's direct path (no shared window) bit for bit
   against its plain version;
16d. the parallel layer at world size 1 (parallel_phase): a real NCCL
   group joined from torchrun's environment on a free local port, a
   ("data", "model") = (1, 1) mesh over it; THAT_ENCODER at full width
   through fit for 3 steps at batch 16 and a validation chunk, plain, with
   the gradient all-reduce, with FSDP2 and with the tensor-parallel rules
   applied (K1/K2 on the rank's heads), from one seed with dropout and
   augmentation on: each wrapped run's losses within PARALLEL_REL (1e-5)
   of the plain run's and the same K1 and K2 launches; MViT-v2 at
   (45, 224, 224) through fit_video, 2 steps at batch 2, plain, with FSDP2
   and with the rules (K3/K4 on the rank's heads): the loss within 1e-5,
   the accuracies equal, the same K3 and K4 launches; one step of each
   way profiled (device ms beside the plain step's, the hand kernels'
   launches equal to the plain step's, the NCCL kernels and collectives
   counted); DETR at entry's shape, (8, 3000, 270), two steps plain and
   with the rules: both losses within 1e-5 and the first step's gradients
   within 1e-4 of each tensor's largest; ring attention at (16, 10, 150,
   27) f32 against full attention within 1e-5; InfoNCE with the gather
   through NCCL against the plain loss; dryrun_multichip(1) in the same
   group, which prints its line; the group destroyed, and the phase's
   seconds;
17. the whole run's wall time, one JSON line describing each kernel
   (every TPU kernel of the repo is ported, and P1's prologue, its 3-D
   prologue and its implicit conv; K1, K2 and K3 with one entry per
   dtype),
   then the card's name and power limit, then the result line.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
REQUESTS = (256, 100, 300)
LENGTH, CHANNELS = 3000, 270
F32_TOL = 2e-5            # kernel vs plain, f32 (tests/test_kernels.py:62)
BF16_TOL = 2.0 ** -6      # kernel vs plain, bf16: two bf16 steps below 2
SERVE_F32_TOL = 1e-4      # card vs CPU logits, f32, atol and rtol
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s per dtype
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
PEAK_TF32 = 495e12        # dense TF32 tensor cores: K3's bf16 bias
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
RESIDENT_ROUNDS = 3        # timings of the requests already on the card
PROFILED_FORWARDS = 5
TOP_KERNELS = 12           # listed from the profile, by device time
KERNEL_SHAPES = {          # name: (q shape (B, Nq, H, D), Nk)
    "that-left": ((256, 150, 10, 27), 150),
    "that-right": ((256, 270, 10, 15), 270),
    "that-encoder-right": ((256, 270, 10, 27), 270),
    "ragged": ((3, 64, 10, 15), 64),
    "cross": ((4, 128, 6, 45), 420),
}
# K1 in both dtypes at 2048 keys of THAT's D = 27: both tensor-core
# bodies stream the keys (the f32 kernel before them stopped at 933)
KERNEL_LONG_SHAPES = {"long": ((4, 256, 10, 27), 2048)}
# K1 in f32 at the training batch (TRAIN_BATCH): the THAT and
# THAT_ENCODER shapes of a training step's forward
K1_TRAIN_SHAPES = ("that-left", "that-right", "that-encoder-right")
K1_F32 = "attention_f32_kernel"     # the f32 body's kernel name
# K2, per gradient against the plain version's largest magnitude: f32 the
# JAX package's bound for its own kernel (tests/test_kernels.py:165-168);
# bf16 one rounding step of the largest value (both store bf16 gradients
# and round the weights for dV, and f32 sums in another order can land on
# the other side of a step)
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
BWD_SHAPES = {
    "that-left-16": ((16, 150, 10, 27), 150),
    "that-right-16": ((16, 270, 10, 15), 270),
    "that-encoder-right-16": ((16, 270, 10, 27), 270),
    "that-left-256": ((256, 150, 10, 27), 150),
    "that-right-256": ((256, 270, 10, 15), 270),
    "ragged": ((3, 70, 10, 15), 97),
    "cross": ((4, 128, 6, 45), 300),
}
TRAIN_WINDOWS, VALID_WINDOWS, TRAIN_BATCH = 80, 32, 16
TRAIN_RATE_STEPS = 10      # timed training steps after a warm-up step
PROFILED_STEPS = 5
STEP_F32_TOL = 1e-5        # card vs CPU training-step loss, relative
GRAD_F32_TOL = 1e-4        # card vs CPU gradients, of each tensor's scale
STATS_F32_TOL = 1e-4       # card vs CPU BatchNorm statistics after a step,
                           # of each buffer's largest magnitude: f32 means
                           # over up to 1.6M elements summed in another order
K5_SHAPES = {"trace": (3000, 270), "ragged": (2999, 270),
             "batch": (8, 3000, 270)}
# K5's phase against torch.atan2 and against numpy's angle, in ulp of the
# plain value: CUDA documents atan2f at 3 ulp, numpy's C library at 1
PHASE_ULPS = 4
# card amplitude sqrt(re^2 + im^2) against numpy's hypot: each within one
# ulp of the exact value, so 2 ulp (2^-22 = 2.38e-7) apart at most
AMP_HOST_REL = 2.4e-7
K5_OPS = 5                 # per element: 2 products, a sum, a root, atan2
TRACES, PACKETS = 4, 3000  # synthetic WiMANS traces preprocessed
RUN_WINDOWS, RUN_EPOCHS = 48, 2   # the experiment path's dataset and epochs
RESULT_KEYS = {"complexity", "repeat_0", "accuracy", "time_train",
               "time_test", "final_metrics", "model", "task", "data", "nn"}
# K3 at MViT's serving shapes, (2, 45, 224, 224, 3) bf16: per block
# (B, H, Nq, Nk, D, M of v2's bias) and its launches in one forward
LOWRANK_SHAPES = {
    "block0": ((2, 1, 72129, 1128, 96, 37), 1),
    "block1": ((2, 2, 18033, 4509, 96, 51), 1),
    "block2": ((2, 2, 18033, 1128, 96, 37), 1),
    "block3": ((2, 4, 4509, 4509, 96, 51), 1),
    "blocks4-13": ((2, 4, 4509, 1128, 96, 37), 10),
    "block14": ((2, 8, 1128, 4509, 96, 51), 1),
    "block15": ((2, 8, 1128, 1128, 96, 37), 1),
}
# the JAX package's own K3 test shapes (tests/test_kernels.py:85-86)
LOWRANK_ODD = {"odd-300": (2, 1, 300, 37, 16, 5),
               "odd-513": (1, 2, 513, 129, 8, 11),
               "odd-257": (2, 4, 257, 128, 24, 9),
               "odd-128": (1, 8, 128, 128, 96, 0)}
# f32 shapes where the 8-warp configuration's tiles do not fit in shared
# memory, so the f32 launcher takes 4 warps over 64 rows and key tiles of
# 32: a bias past 64 factor columns at D = 96, and a head of 128
LOWRANK_NARROW = {"d96-m70": (2, 2, 18033, 1128, 96, 70),
                  "d128-m37": (1, 2, 4099, 1128, 128, 37)}
# K3 against its plain version: f32 the JAX test's 2e-5; bf16 2^-7 of the
# largest |out| (one rounding step of it); the LSE 1e-5 relative
LOWRANK_BF16_SHARE = 2.0 ** -7
LOWRANK_LSE_RTOL = 1e-5
LOWRANK_REPS = 3           # timed calls per measurement at the big shapes
VIDEO_CLIP = (45, 224, 224)
VIDEO_REQUESTS = (2, 1, 3)
VIDEO_OUT = 6              # the identity task's head (cli/run_video.py:20)
K3_PER_FORWARD = 16
VIDEO_CPU_CLIP = (16, 112, 112)   # card vs CPU: stage 1 has 6273 queries
VIDEO_CPU_K3 = 14          # blocks at nq >= 256 there (stage 4 has 129)
VIDEO_F32_SHARE = 1e-4     # card vs CPU, of the largest logit
PRETRAINED_CLIP = (16, 224, 224)  # torchvision's own clip size
EVAL_CLIPS = 5
K3 = "flash_attention_lowrank_bias"
DQ = "flash_attention_lowrank_bias_backward_dq"
DKV = "flash_attention_lowrank_bias_backward_dkv"
# K4 at MViT's training shapes, (2, 45, 224, 224, 3): blocks 0-2 pass the
# training gate of 8192 queries; per block (B, H, Nq, Nk, D, M of v2's bias)
LOWRANK_BWD_SHAPES = {name: LOWRANK_SHAPES[name][0]
                      for name in ("block0", "block1", "block2")}
# the JAX package's own K4 test shapes (tests/test_kernels.py:114-141), a
# bias wider than the kernels' chunk of 64, the largest head dim, and
# two more head dims
LOWRANK_BWD_ODD = {"odd-300": (2, 2, 300, 130, 32, 11),
                   "odd-513": (1, 2, 513, 129, 8, 0),
                   "odd-wide-bias": (1, 2, 130, 70, 8, 70),
                   "odd-d128": (1, 1, 200, 100, 128, 3),
                   # the f32 dK/dV/dS body's other configurations: Q and
                   # dO split once a tile with two warps a key strip
                   # (D = 96, M = 70), and the span of 4 k-steps (D = 64)
                   "odd-d96-m70": (1, 2, 300, 200, 96, 70),
                   "odd-d64": (1, 2, 300, 130, 64, 11)}
# K4 against its plain version, each gradient against its largest
# magnitude: f32 5e-5 (sums over up to 72129 rows or 4509 keys in another
# order; the largest seen on an H100 was 1.7e-5, dQ and dV at
# odd-wide-bias); bf16 2^-7, one
# rounding step of the largest value (dQ, dK and dV are stored in bf16 by
# both)
LOWRANK_BWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2.0 ** -7}
# each bf16 kernel's distance from float64 at MViT's training blocks, at
# most this many times its plain version's (both round dQ, dK and dV to
# bf16; the kernels keep 16 bits of w and dl in their products)
BF16_F64_RATIO = 2.0
K4_PER_STEP = 3            # MViT blocks at the training gate
VIDEO_TRAIN_BATCH = 2      # the JAX bench's (tools/bench_video_training.py)
VIDEO_CLI_BATCH = 8        # the JAX CLI's (cli/run_video.py:36)
RUN_CLIPS = 10             # the video run: 8 training and 2 test clips
VIDEO_STEP_CLIP = (32, 224, 224)  # card vs CPU step: blocks 0-2 at 50177,
                                  # 12545 and 12545 queries pass the gate
VIDEO_RESULT_KEYS = {"complexity", "repeat_0", "accuracy", "time_train",
                     "time_test", "model", "task"}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def pytorch_defaults() -> None:
    """PyTorch's own precision flags, as a user's process has them: f32
    matmuls in full f32, cuDNN's TF32 on. The port pins its f32 cuDNN
    calls (convolutions and LSTMs, and their backward in its training
    steps) to full f32 itself (``core/device.py::cudnn_f32``), so every
    phase checks the port as its entry points run it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, from CUDA events around ``reps`` calls
    after ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(shape, nk, dtype):
    """The least times (ms) one attention call needs on an H100 SXM: q, k,
    v read once and the output written once over the HBM rate, and the
    QK^T and PV products (2 * 2 * B*H*Nq*Nk*D operations) over the peak
    rate for the dtype. The bound is the larger of the two. The third time
    is the operations bound with every product as three TF32 products
    (3xTF32) over the TF32 tensor-core peak, as the f32 kernel computes
    them; in bf16 it is the second."""
    b, nq, h, d = shape
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * nq * h * d + 2 * b * nk * h * d) * item
    flops = 4.0 * b * h * nq * nk * d
    ops_ms = 1e3 * flops / PEAK_FLOPS[dtype]
    tf32_ms = (1e3 * 3 * flops / PEAK_TF32 if dtype == torch.float32
               else ops_ms)
    return 1e3 * nbytes / PEAK_BYTES, ops_ms, tf32_ms


def attention_f64(q, k, v):
    """K1's function computed in float64 (the f32 kernel's and the plain
    version's own rounding errors are measured against it)."""
    q, k, v = (t.double() for t in (q, k, v))
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                      / q.shape[-1] ** 0.5, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def phase_kernel(flash_attention, flash_attention_reference):
    """K1 against its plain version at every shape, f32 within F32_TOL and
    bf16 within BF16_TOL; f32 the same bits twice and its distance from
    float64 at that-encoder-right-16. Times at the main path's shapes
    (CUDA events: plain, kernel, kernel, plain) beside
    scaled_dot_product_attention and the bounds; in f32 also each call's
    device time from the profiler (the f32 kernel, the plain version and
    SDPA's own kernels). A head dim of 129 must be refused in both dtypes;
    4096 keys of D = 27 launch in f32."""
    import torch.nn.functional as F
    from multi_modal_csi_tpu_torch.kernels.flash_attention import (
        TC_MAX_HEAD_DIM)
    pytorch_defaults()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    train = {f"{name}-{TRAIN_BATCH}": ((TRAIN_BATCH, *shape[1:]), nk)
             for name, (shape, nk) in KERNEL_SHAPES.items()
             if name in K1_TRAIN_SHAPES}
    # in this order the inputs of every case that ran before the f32
    # kernel's long and training cases are drawn as they were
    groups = ((torch.float32, KERNEL_SHAPES),
              (torch.bfloat16, {**KERNEL_SHAPES, **KERNEL_LONG_SHAPES}),
              (torch.float32, train), (torch.float32, KERNEL_LONG_SHAPES))
    for dtype, shapes in groups:
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for name, (shape, nk) in shapes.items():
            b, nq, h, d = shape
            q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, nk, h, d), generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn((b, nk, h, d), generator=gen,
                            device="cuda").to(dtype)
            got = flash_attention(q, k, v)
            want = flash_attention_reference(q, k, v)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            print(f"K1 {name} {tuple(shape)} nk={nk} {dtype}: max abs err "
                  f"{err:.3e} (tolerance {tol:.3e})")
            check(got.dtype == dtype and got.shape == q.shape,
                  f"K1 {name} {dtype} output {got.dtype} {tuple(got.shape)}")
            check(err <= tol, f"K1 {name} {dtype} err {err} > {tol}")
            if (dtype == torch.float32
                    and name == f"that-encoder-right-{TRAIN_BATCH}"):
                # the same bits twice: every sum in one order, no atomics
                same = torch.equal(got, flash_attention(q, k, v))
                print(f"K1 {name} f32 twice: bit for bit {same}")
                check(same, f"K1 {name} f32 differs run to run")
                exact = attention_f64(q, k, v)
                top = exact.abs().max()
                print(f"K1 {name} f32 against the same function in f64, "
                      f"of the output's max: kernel "
                      f"{((got.double() - exact).abs().max() / top):.3e}, "
                      f"plain {((want.double() - exact).abs().max() / top):.3e}")
                del exact
            if not name.startswith("that"):
                continue
            del got, want
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            plain = [cuda_ms(lambda: flash_attention_reference(q, k, v))]
            kern = [cuda_ms(lambda: flash_attention(q, k, v))
                    for _ in range(2)]
            plain.append(cuda_ms(lambda: flash_attention_reference(q, k, v)))
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            bytes_ms, ops_ms, tf32_ms = attention_bound(shape, nk, dtype)
            row = dict(err=err, ms=sum(kern) / 2, plain_ms=sum(plain) / 2,
                       library_ms=lib, bytes_ms=bytes_ms, ops_ms=ops_ms,
                       tf32_ms=tf32_ms)
            device = ""
            if dtype == torch.float32:
                # device time: CUDA events around short launches also
                # count the host's gaps between them
                by_kernel = kernel_ms(lambda: flash_attention(q, k, v))
                check(all(K1_F32 in key for key in by_kernel),
                      f"K1 {name} f32 ran {sorted(by_kernel)}")
                sdpa = kernel_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt))
                row.update(event_ms=row["ms"], plain_event_ms=row[
                    "plain_ms"], library_event_ms=lib,
                    ms=sum(by_kernel.values()),
                    plain_ms=device_ms(lambda: flash_attention_reference(
                        q, k, v)),
                    library_ms=sum(sdpa.values()))
                device = (f"; device time (profiler): kernel "
                          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}"
                          f" ms, sdpa {row['library_ms']:.4f} ms ("
                          + "; ".join(f"{key[:60]} {t:.4f}"
                                      for key, t in sdpa.items()) + ")")
            results[(name, dtype)] = row
            print(f"K1 {name} {tuple(shape)} {dtype} per launch: kernel "
                  f"{kern[0]:.4f}/{kern[1]:.4f} ms, plain {plain[0]:.4f}/"
                  f"{plain[1]:.4f} ms, sdpa {lib:.4f} ms (CUDA events)"
                  f"{device}; bound: bytes {1e3 * bytes_ms:.1f} us, "
                  f"operations {1e3 * ops_ms:.1f} us"
                  + (f" (3xTF32 {1e3 * tf32_ms:.1f} us)"
                     if dtype == torch.float32 else ""))

    # per THAT and THAT_ENCODER training step (4 left + 1 right launches)
    for model, right in (("THAT", "that-right"),
                         ("THAT_ENCODER", "that-encoder-right")):
        rows = [results[(f"{n}-{TRAIN_BATCH}", torch.float32)]
                for n in ("that-left",) * 4 + (right,)]

        def total(field):
            return sum(r[field] for r in rows)

        bytes_ms = total("bytes_ms")
        print(f"K1 f32 per {model} training step at batch {TRAIN_BATCH} (4 "
              f"left + 1 right), device time: kernel {total('ms'):.4f} ms, "
              f"plain {total('plain_ms'):.4f} ms, sdpa "
              f"{total('library_ms'):.4f} ms; CUDA events: kernel "
              f"{total('event_ms'):.4f} ms, sdpa "
              f"{total('library_event_ms'):.4f} ms; bound "
              f"{max(bytes_ms, total('ops_ms')):.4f} ms at the f32 peak, "
              f"{max(bytes_ms, total('tf32_ms')):.4f} ms as 3xTF32")

    # a head dim past the tensor-core bodies' spans: refused in both
    # dtypes; in f32, 4096 keys of THAT's head dim launch (keys stream)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 64, 1, TC_MAX_HEAD_DIM + 1), device="cuda",
                        dtype=dtype)
        try:
            flash_attention(q, q, q)
            refused = False
        except ValueError as e:
            print(f"K1 {dtype} D={TC_MAX_HEAD_DIM + 1}: refused ({e})")
            refused = True
        check(refused, f"K1 {dtype} launched at D={TC_MAX_HEAD_DIM + 1}")
    q = torch.randn((1, 64, 1, 27), generator=gen, device="cuda")
    kv = torch.randn((1, 4096, 1, 27), generator=gen, device="cuda")
    err = (flash_attention(q, kv, kv)
           - flash_attention_reference(q, kv, kv)).abs().max().item()
    print(f"K1 f32 Nk=4096 D=27: launched, max abs err {err:.3e}")
    check(err <= F32_TOL, f"K1 f32 Nk=4096 err {err} > {F32_TOL}")
    return results


def backward_bound(shape, nk, dtype):
    """The least times (ms) one attention backward needs on an H100 SXM:
    q, k, v and dO read once and dQ, dK, dV written once over the HBM
    rate, and the five products (QK^T and dO V^T recomputed, dQ, dK, dV:
    10 * B*H*Nq*Nk*D operations) over the peak rate for the dtype. The
    third time is the operations bound with every product as three TF32
    products (3xTF32) over the TF32 tensor-core peak, as the f32 kernels
    compute them; in bf16 it is the second."""
    b, nq, h, d = shape
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (3 * b * nq * h * d + 4 * b * nk * h * d) * item
    flops = 10.0 * b * h * nq * nk * d
    ops_ms = 1e3 * flops / PEAK_FLOPS[dtype]
    tf32_ms = (1e3 * 3 * flops / PEAK_TF32 if dtype == torch.float32
               else ops_ms)
    return 1e3 * nbytes / PEAK_BYTES, ops_ms, tf32_ms


def backward_f64(q, k, v, do):
    """K2's dQ, dK and dV computed in float64 from the same inputs (the
    kernel's and the plain version's own rounding errors are measured
    against it)."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = 1.0 / q.shape[-1] ** 0.5
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
    dw = torch.einsum("bqhd,bkhd->bhqk", do, v)
    dl = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    return (torch.einsum("bhqk,bkhd->bqhd", dl, k) * scale,
            torch.einsum("bhqk,bqhd->bkhd", dl, q) * scale,
            torch.einsum("bhqk,bqhd->bkhd", w, do))


def kernel_ms(fn, reps=20):
    """Device ms per call of ``fn`` by CUDA kernel name, from
    torch.profiler over ``reps`` calls after one untimed call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


# (B, N, H, D) at Nq = Nk where K2 bf16's copies (tc_attention_bwd.cuh's
# bwd_pick_copy) take other widths than THAT's 4-byte pieces: 8-byte
# pieces shifted by 1-3 positions, 8-byte pieces filling a span of 128,
# 16-byte pieces shifted by 4, and an odd row stride (element by element)
K2_COPY_SHAPES = {"8-byte": (2, 100, 4, 27), "span-128": (2, 64, 4, 126),
                  "16-byte": (2, 50, 8, 100), "odd-row": (3, 33, 5, 13)}
# K2's two kernels in each dtype, by the names the profiler lists
K2_PASSES = {torch.float32: {"query": "attention_bwd_dq_f32_kernel",
                             "dkv": "attention_bwd_dkv_f32_kernel"},
             torch.bfloat16: {"query": "attention_bwd_dq_bf16_kernel",
                              "dkv": "attention_bwd_dkv_bf16_kernel"}}
# the right stream's BWD_SHAPES entry of each model's training step
K2_STEPS = {"THAT": "that-right-16", "THAT_ENCODER": "that-encoder-right-16"}


def phase_backward(backward, backward_reference):
    """K2 against its plain version at every shape and dtype, each
    gradient within BWD_TOL of its largest magnitude, and the same bits
    twice (the query pass and the dK/dV pass of the tensor-core backward
    body in both dtypes: no atomics). Times at the training shapes (plain,
    kernel, kernel, plain, with CUDA events), beside the backward of
    scaled_dot_product_attention and the bounds (f32: at the f32 peak and
    as 3xTF32), summed per THAT and THAT_ENCODER training step in each
    dtype; each pass's device time from the profiler; at
    that-encoder-right-16 the distance of the kernel and of its plain
    version from float64 (``backward_f64``), in bf16 the kernel's at most
    BF16_F64_RATIO times the plain version's; at K2_COPY_SHAPES, where
    bf16 copies rows in other widths, within BWD_TOL and the same bits
    twice. K2 must refuse past the tensor-core spans (D = 129) in both
    dtypes."""
    import torch.nn.functional as F
    pytorch_defaults()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for dtype, tol in BWD_TOL.items():
        for name, (shape, nk) in BWD_SHAPES.items():
            b, nq, h, d = shape
            q, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                     for _ in range(2))
            k, v = (torch.randn((b, nk, h, d), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            got = backward(q, k, v, do)
            want = backward_reference(q, k, v, do)
            torch.cuda.synchronize()
            errs = [(g.float() - w.float()).abs().max().item() for g, w in
                    zip(got, want)]
            tops = [w.float().abs().max().item() for w in want]
            print(f"K2 {name} {tuple(shape)} nk={nk} {dtype}: max abs err "
                  f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
                  f"(tolerance {tol:.1e} of max |grad|: {tops[0]:.3f}, "
                  f"{tops[1]:.3f}, {tops[2]:.3f})")
            for g, w, err, top in zip(got, want, errs, tops):
                check(g.dtype == dtype and g.shape == w.shape,
                      f"K2 {name} {dtype} gradient {g.dtype} "
                      f"{tuple(g.shape)}")
                check(err <= tol * top, f"K2 {name} {dtype} err {err} > "
                                        f"{tol} x {top}")
            # the same bits twice: no atomics, every sum in one order
            again = backward(q, k, v, do)
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            check(same, f"K2 {name} {dtype} differs run to run")
            del again
            if name == "that-encoder-right-16":
                exact = backward_f64(q, k, v, do)

                def share(g, x):
                    return ((g.double() - x).abs().max()
                            / x.abs().max()).item()

                shares = [(share(g, x), share(w, x))
                          for g, w, x in zip(got, want, exact)]
                print(f"K2 {name} {DTYPE_NAMES[dtype]} against the same "
                      f"function in f64, of each gradient's max: " + ", ".join(
                          f"{n} kernel {a:.3e} plain {c:.3e}" for n, (a, c)
                          in zip(("dq", "dk", "dv"), shares)))
                if dtype == torch.bfloat16:
                    check(all(a <= BF16_F64_RATIO * c for a, c in shares),
                          f"K2 {name} bf16 farther from f64 than "
                          f"{BF16_F64_RATIO} x the plain version: {shares}")
                del exact
            del got, want
            if not name.startswith("that"):
                continue
            plain = [cuda_ms(lambda: backward_reference(q, k, v, do))]
            kern = [cuda_ms(lambda: backward(q, k, v, do)) for _ in range(2)]
            plain.append(cuda_ms(lambda: backward_reference(q, k, v, do)))
            leaves = [t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves)
            dot = do.transpose(1, 2)
            # out.backward(dot, retain_graph=True) without accumulating
            lib = cuda_ms(lambda: torch.autograd.grad(out, leaves, dot,
                                                      retain_graph=True))
            bytes_ms, ops_ms, tf32_ms = backward_bound(shape, nk, dtype)
            row = dict(err=max(errs), ms=sum(kern) / 2,
                       plain_ms=sum(plain) / 2, library_ms=lib,
                       bytes_ms=bytes_ms, ops_ms=ops_ms, tf32_ms=tf32_ms)
            by_kernel = kernel_ms(lambda: backward(q, k, v, do))
            for part, kernel in K2_PASSES[dtype].items():
                row[f"{part}_ms"] = sum(t for key, t in by_kernel.items()
                                        if kernel in key)
            check(row["query_ms"] > 0 and row["dkv_ms"] > 0,
                  f"K2 {name} {dtype}: the profile lists no pass of "
                  f"{K2_PASSES[dtype]}")
            results[(name, dtype)] = row
            print(f"K2 {name} {dtype} per launch: kernel {kern[0]:.4f}/"
                  f"{kern[1]:.4f} ms (profiler: query pass "
                  f"{row['query_ms']:.4f} ms, dK/dV pass {row['dkv_ms']:.4f}"
                  f" ms), plain {plain[0]:.4f}/{plain[1]:.4f} ms, sdpa "
                  f"backward {lib:.4f} ms; bound: bytes {1e3 * bytes_ms:.1f}"
                  f" us, operations {1e3 * ops_ms:.1f} us"
                  + (f" (3xTF32 {1e3 * tf32_ms:.1f} us)"
                     if dtype == torch.float32 else ""))

    for dtype, tol in BWD_TOL.items():
        for name, shape in K2_COPY_SHAPES.items():
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                           .to(dtype) for _ in range(4))
            got = backward(q, k, v, do)
            want = backward_reference(q, k, v, do)
            again = backward(q, k, v, do)
            errs = [(g.float() - w.float()).abs().max().item() for g, w in
                    zip(got, want)]
            tops = [w.float().abs().max().item() for w in want]
            print(f"K2 {name} {shape} {dtype}: max abs err " + ", ".join(
                f"{n} {e:.3e} of {t:.3f}" for n, e, t in
                zip(("dq", "dk", "dv"), errs, tops)))
            check(all(e <= tol * t for e, t in zip(errs, tops)),
                  f"K2 {name} {dtype} errs {errs} > {tol} x {tops}")
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"K2 {name} {dtype} differs run to run")

    for model, right in K2_STEPS.items():
        for dtype in BWD_TOL:
            rows = [results[(shape, dtype)] for shape in
                    ("that-left-16",) * 4 + (right,)]

            def total(field):
                return sum(r[field] for r in rows)

            bytes_ms = total("bytes_ms")
            passes = K2_PASSES[dtype]
            bound = (f"{max(bytes_ms, total('ops_ms')):.4f} ms at the "
                     f"{DTYPE_NAMES[dtype]} peak")
            if dtype == torch.float32:
                bound += (f", {max(bytes_ms, total('tf32_ms')):.4f} ms as "
                          f"3xTF32")
            print(f"K2 per {model} {DTYPE_NAMES[dtype]} training step at "
                  f"batch 16 (4 left + 1 right): kernel {total('ms'):.4f} ms"
                  f" (profiler: {passes['query']} {total('query_ms'):.4f}, "
                  f"{passes['dkv']} {total('dkv_ms'):.4f}), plain "
                  f"{total('plain_ms'):.4f} ms, sdpa backward "
                  f"{total('library_ms'):.4f} ms; bound {bound}")

    # both dtypes' tensor-core kernels stream their tiles: refused only
    # past their spans
    for dtype in BWD_TOL:
        q = torch.zeros((1, 64, 1, 129), device="cuda", dtype=dtype)
        try:
            backward(q, q, q, q)
            refused = False
        except ValueError as e:
            print(f"K2 {DTYPE_NAMES[dtype]} Nk=64 D=129: refused ({e})")
            refused = True
        check(refused, f"K2 {dtype} launched at Nk=64, D=129")
    return results


def ulps(got, want):
    """|got - want| in units in the last place of |want| (float32)."""
    w = want.float().abs()
    ulp = torch.nextafter(w, torch.full_like(w, math.inf)) - w
    return (got.float() - want.float()).abs() / ulp


PROFILE_TRIES = 4          # device_ms: windows profiled at most


def device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of ``fn``: the CUDA kernels' own time
    from torch.profiler over ``reps`` calls, after one untimed call. A
    window that holds no device time at all (the profiler has been seen
    to drop a short window's CUDA events on an H100, twice in a row at
    K5's 4-microsecond calls) is profiled again, up to PROFILE_TRIES
    windows in all, and the last must hold device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            break
        print("device_ms: the profile held no device time; profiling the "
              "window again")
    check(us > 0, "the profile holds no device time")
    return us / 1e3 / reps


def k5_bound(n):
    """The least times (ms) one amplitude-phase pass over n elements needs
    on an H100 SXM: re and im read and amp and phase written once, 16 bytes
    an element, over the HBM rate, and K5_OPS f32 operations an element
    over the f32 peak."""
    return 1e3 * 16 * n / PEAK_BYTES, 1e3 * K5_OPS * n / PEAK_FLOPS[
        torch.float32]


def phase_k5(amplitude_phase, amplitude_phase_reference):
    """K5 against its plain version; times at one trace and a batch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    cases = dict(K5_SHAPES, unaligned=(3000, 270))
    for name, shape in cases.items():
        n = math.prod(shape)
        if name == "unaligned":       # one float in: not 16-byte aligned
            flat = torch.randn((2, n + 1), generator=gen, device="cuda")
            re, im = (flat[i, 1:].view(shape) for i in range(2))
        else:
            re, im = (torch.randn(shape, generator=gen, device="cuda")
                      for _ in range(2))
        amp, phase = amplitude_phase(re, im)
        want_amp, want_phase = amplitude_phase_reference(re, im)
        torch.cuda.synchronize()
        amp_err = (amp - want_amp).abs().max().item()
        phase_err = (phase - want_phase).abs().max().item()
        phase_ulps = ulps(phase, want_phase).max().item()
        print(f"K5 {name} {tuple(shape)}: amplitude max abs err {amp_err:.3e}"
              f" (must be 0), phase max abs err {phase_err:.3e}, "
              f"{phase_ulps:.1f} ulp (tolerance {PHASE_ULPS} ulp)")
        check(amp.shape == phase.shape == re.shape
              and amp.dtype == phase.dtype == torch.float32,
              f"K5 {name} outputs {tuple(amp.shape)} {amp.dtype}")
        check(amp_err == 0.0, f"K5 {name} amplitude differs by {amp_err}")
        check(phase_ulps <= PHASE_ULPS,
              f"K5 {name} phase {phase_ulps} ulp > {PHASE_ULPS}")
        if name == "unaligned":
            continue
        calls = {"kernel": lambda: amplitude_phase(re, im),
                 "plain": lambda: amplitude_phase_reference(re, im),
                 "library": lambda: (torch.hypot(re, im),
                                     torch.atan2(im, re))}
        # events around back-to-back calls (at one trace the host's call
        # overhead sets that pace), then the device's own time per call
        events = {k: cuda_ms(fn) for k, fn in calls.items()}
        device = {k: [device_ms(fn) for _ in range(2)]
                  for k, fn in calls.items()}
        bytes_ms, ops_ms = k5_bound(n)
        traces = n / (3000 * 270)
        results[name] = dict(err=max(amp_err, phase_err),
                             ms=sum(device["kernel"]) / 2,
                             plain_ms=sum(device["plain"]) / 2,
                             library_ms=sum(device["library"]) / 2,
                             bytes_ms=bytes_ms, ops_ms=ops_ms)
        print(f"K5 {name} device time per call (profiler, two runs): "
              + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f} ms"
                          for k, v in device.items())
              + "; per call from CUDA events around 20 calls: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in events.items())
              + f"; kernel per trace {sum(device['kernel']) / 2 / traces:.4f}"
              f" ms; bound: bytes {1e3 * bytes_ms:.1f} us, operations "
              f"{1e3 * ops_ms:.2f} us")
    return results


def write_traces(dir_mat, n, packets, seed=SEED):
    """``n`` synthetic WiMANS .mat traces of ``packets`` packets: a (T, 1)
    object cell of (1, 1) struct records whose LAST field is the (3, 3, 30)
    complex64 CSI, as the dataset nests them."""
    import scipy.io as scio
    rng = np.random.default_rng(seed)
    rec_dt = np.dtype([("timestamp", "O"), ("csi", "O")])
    os.makedirs(dir_mat, exist_ok=True)
    for i in range(n):
        csi = (rng.standard_normal((packets, 3, 3, 30))
               + 1j * rng.standard_normal((packets, 3, 3, 30))
               ).astype(np.complex64)
        cell = np.empty((packets, 1), dtype=object)
        for t in range(packets):
            rec = np.empty((1, 1), dtype=rec_dt)
            rec[0, 0] = (np.float64(t), csi[t])
            cell[t, 0] = rec
        scio.savemat(os.path.join(dir_mat, f"act_{i}.mat"), {"trace": cell})


def preprocess_phase(work):
    """The preprocessing CLI's main path on the card (the default device),
    then the host path on the same traces. Returns the launch counts and
    the card's amplitude directory."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.cli.preprocess_csi import (STAGES,
                                                              extract_csi_amp)
    dir_mat = os.path.join(work, "mat")
    write_traces(dir_mat, TRACES, PACKETS)
    card = {k: os.path.join(work, "card", k) for k in ("amp", "phase")}
    host = {k: os.path.join(work, "host", k) for k in ("amp", "phase")}
    seconds = {}
    kernels.reset_launch_counts()
    start = time.perf_counter()
    n = extract_csi_amp(dir_mat, card["amp"], card["phase"],
                        seconds=seconds)
    wall = time.perf_counter() - start
    launches = dict(kernels.LAUNCH_COUNTS)
    print(f"preprocess on the card: {n} traces of {PACKETS} packets in "
          f"{wall:.3f} s; launches {launches}; seconds per trace: "
          + ", ".join(f"{s} {seconds[s] / n:.5f}" for s in STAGES
                      if s in seconds))
    check(n == TRACES and launches == {"csi_amplitude_phase": TRACES}
          and set(seconds) == set(STAGES),
          f"preprocess converted {n} traces with launches {launches}, "
          f"stages {sorted(seconds)}")
    host_seconds = {}
    start = time.perf_counter()
    extract_csi_amp(dir_mat, host["amp"], host["phase"], device="cpu",
                    seconds=host_seconds)
    print(f"preprocess on the host (--device cpu): {n} traces in "
          f"{time.perf_counter() - start:.3f} s; seconds per trace: "
          + ", ".join(f"{s} {host_seconds[s] / n:.5f}" for s in STAGES
                      if s in host_seconds))
    worst_rel = worst_ulps = 0.0
    for name in sorted(os.listdir(host["amp"])):
        a_card, a_host, p_card, p_host = (
            torch.from_numpy(np.load(os.path.join(d[k], name)))
            for d, k in ((card, "amp"), (host, "amp"), (card, "phase"),
                         (host, "phase")))
        check(a_card.shape == a_host.shape == (PACKETS, 3, 3, 30),
              f"preprocess {name}: shapes {tuple(a_card.shape)}")
        rel = ((a_card - a_host).abs() / a_host.abs().clamp_min(1e-30)
               ).max().item()
        worst_rel = max(worst_rel, rel)
        worst_ulps = max(worst_ulps, ulps(p_card, p_host).max().item())
    print(f"preprocess card vs host: amplitude max rel err {worst_rel:.3e} "
          f"(tolerance {AMP_HOST_REL}), phase {worst_ulps:.1f} ulp "
          f"(tolerance {PHASE_ULPS})")
    check(worst_rel <= AMP_HOST_REL, f"card vs host amplitude {worst_rel}")
    check(worst_ulps <= PHASE_ULPS, f"card vs host phase {worst_ulps} ulp")
    return launches, card["amp"]


def profile_device(label, fn, count, unit):
    """Device time of ``count`` calls of ``fn`` by kernel, from
    torch.profiler: per ``unit``, busy share of the wall time, and the
    kernels with the most device time. Returns the device ms per ``unit``
    and, by kernel name, its ms per ``unit``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = time.perf_counter()
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
    events = prof.key_averages()
    # device-side spans of record_function ranges (Adam's step) cover
    # kernels already listed: leave them out
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    device_us = sum(e.self_device_time_total for e in kernels)
    check(device_us > 0, f"{label}: the profile holds no device time")
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    launches = sum(e.count for e in host
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    print(f"{label} profiled: {device_us / 1e3 / count:.3f} ms device time "
          f"per {unit}; device busy {100 * device_us / 1e6 / wall:.1f}% of "
          f"{wall * 1e3:.1f} ms wall ({count} {unit}s, profiler on); "
          f"{launches // count} kernel launch calls per {unit}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total
                    )[:TOP_KERNELS]:
        share = 100 * e.self_device_time_total / device_us
        ms = e.self_device_time_total / 1e3 / count
        print(f"  {share:5.1f}%  {ms:8.3f} ms/{unit}  "
              f"{e.count // count:4d}x  {e.key[:90]}")
    return {"device_ms": device_us / 1e3 / count,
            "kernels": {e.key: e.self_device_time_total / 1e3 / count
                        for e in kernels}}


def attention_share(key, what, profile):
    """Print the bf16 tensor-core attention kernel's (K1's or K3's) device
    ms per forward and share of the device time, from ``profile_device``."""
    ms = sum(t for name, t in profile["kernels"].items()
             if "tc::attention_kernel" in name)
    print(f"{key}: {what} (tc::attention_kernel) {ms:.3f} ms per forward, "
          f"{100 * ms / profile['device_ms']:.1f}% of the device time")


def serve_phase(key, requests, expect_out, launches_per_forward,
                served=None):
    """Serve ``requests`` (host arrays; only the first ``served`` of them
    if given) with ``key`` in bf16 at batch 256, launching K1
    ``launches_per_forward`` times a forward and no other kernel; then
    hold the same weights at f32 on the card against the CPU, on 4
    windows of the second request, within SERVE_F32_TOL (absolute and
    relative); for the WiMANS baselines the CPU takes the card's side at
    every leaky-ReLU kink."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.serving import CSIServer
    from multi_modal_csi_tpu_torch.runners.csi import build_model

    phase_start = time.perf_counter()
    cpu_windows = requests[1][:4]
    requests = requests[:served]
    pytorch_defaults()
    server = CSIServer(key, build_model(key, seed=SEED), dtype="bfloat16",
                       device="cuda")
    server(requests[0][:server.batch])                        # warm-up
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    server.forward(torch.from_numpy(requests[0][:server.batch]))
    torch.cuda.synchronize()
    one = kernels.LAUNCH_COUNTS.get("flash_attention", 0)
    print(f"{key}: K1 launches in one batch forward: {one}")
    check(one == launches_per_forward
          and set(kernels.LAUNCH_COUNTS) <= {"flash_attention"},
          f"{key} launched {dict(kernels.LAUNCH_COUNTS)} in one forward, "
          f"expected {launches_per_forward} K1 and nothing else")

    # the main path: ragged requests from host memory to logits on the host
    kernels.reset_launch_counts()
    start = time.perf_counter()
    outs = [server(r).cpu() for r in requests]
    host_s = time.perf_counter() - start
    launches = dict(kernels.LAUNCH_COUNTS)
    batches = sum(-(-len(r) // server.batch) for r in requests)
    n = sum(len(r) for r in requests)
    for r, out in zip(requests, outs):
        shape = expect_out(len(r))
        print(f"{key}: request of {len(r)} windows -> {tuple(out.shape)}")
        check(tuple(out.shape) == shape,
              f"{key} output {tuple(out.shape)}, expected {shape}")
        check(out.dtype == torch.float32 and bool(torch.isfinite(out).all()),
              f"{key} logits not finite f32")
    k1 = launches.get("flash_attention", 0)
    print(f"{key}: main path ran {batches} batch forwards, K1 launches "
          f"{k1}")
    check(k1 == launches_per_forward * batches,
          f"{key} K1 launches {k1}, expected "
          f"{launches_per_forward * batches}")

    if key in BASELINES:
        # the baselines' rates on the card and profiles: not timed
        # (BASELINES)
        print(f"{key} bf16 batch {server.batch}: {n / host_s:.1f} windows/s "
              f"from host memory, {n} windows in {batches} batch forwards; "
              f"not timed on the card")
        SERVE_RATES[key] = (n / host_s, [])
    else:
        resident = [torch.from_numpy(r).cuda() for r in requests]
        rates = []
        for _ in range(RESIDENT_ROUNDS):
            torch.cuda.synchronize()
            start = time.perf_counter()
            for r in resident:
                server(r)
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - start))
        print(f"{key} bf16 batch {server.batch}: {n / host_s:.1f} windows/s "
              f"from host memory, {n} windows in {batches} batch forwards; "
              f"with the requests already on the card, {RESIDENT_ROUNDS} "
              f"timings: " + ", ".join(f"{r:.1f}" for r in rates)
              + " windows/s")
        SERVE_RATES[key] = (n / host_s, rates)
        batch = resident[0][:server.batch]
        attention_share(key, "K1", profile_device(
            key, lambda: server.forward(batch), PROFILED_FORWARDS,
            "forward"))
        del resident

    # f32 on the card (default flags) against the CPU, where the plain
    # versions run, on the same seeded weights and 4 windows
    pytorch_defaults()
    x = cpu_windows
    kinks = KinkReplay(key if key in BASELINES else None)
    with kinks.on("cuda"):
        card = CSIServer(key, build_model(key, seed=SEED), dtype="float32",
                         device="cuda", batch=4)(x).cpu().numpy()
    with kinks.on("cpu"):
        cpu = CSIServer(key, build_model(key, seed=SEED), dtype="float32",
                        device="cpu", batch=4)(x).numpy()
    err = float(np.abs(card - cpu).max())
    top = float(np.abs(cpu).max())
    print(f"{key} f32 card vs CPU: max abs err {err:.3e} = {err / top:.2e} "
          f"of the largest logit (tolerance {SERVE_F32_TOL} abs + rel)"
          + (f"; {kinks.report()}" if kinks.patches else ""))
    check(np.allclose(card, cpu, atol=SERVE_F32_TOL, rtol=SERVE_F32_TOL),
          f"{key} f32 card vs CPU err {err}")
    print(f"{key} serving phase: {time.perf_counter() - phase_start:.1f} s")
    return launches


# the functions whose kinks and picks a card-vs-CPU comparison replays, by
# model key: (module, function), the function a leaky ReLU (the port's
# ``leaky_relu``, slope 0.01), a ReLU (``F.relu``, which nn.ReLU calls) or
# the port's channels-last ``max_pool3d(v, kernel, stride, padding)``
PORT_MODELS = "multi_modal_csi_tpu_torch.models"
KINKS = {"THAT": ((f"{PORT_MODELS}.csi.that", "leaky_relu"),),
         "CNN-2D": ((f"{PORT_MODELS}.csi.cnn_2d", "leaky_relu"),),
         "CLSTM": ((f"{PORT_MODELS}.csi.clstm", "leaky_relu"),),
         "ABLSTM": ((f"{PORT_MODELS}.csi.ablstm", "leaky_relu"),),
         "MViT-v2": ((f"{PORT_MODELS}.video.mvit", "max_pool3d"),),
         "ResNet": (("torch.nn.functional", "relu"),),
         "S3D": (("torch.nn.functional", "relu"),
                 (f"{PORT_MODELS}.video.s3d", "max_pool3d"))}


class KinkReplay:
    """The devices round differently, so a value within rounding of a kink
    can land on its other side: a leaky ReLU's input near zero takes the
    slope 0.01 instead of 1 (through a BatchNorm after it, one such element
    moves whole gradient tensors by percents), a ReLU's takes 0, and of two
    max-pool candidates within rounding of each other the other is picked
    (the gradient routed elsewhere). Under ``on("cuda")`` the functions of
    ``key`` in KINKS record the side of every input (the element every
    pool window picked); under ``on`` another device they take the
    recorded ones in order and count where that device's own differ, so
    that a comparison measures rounding alone. Each replay must take all
    that was recorded."""

    WHAT = {"leaky_relu": "leaky-ReLU inputs", "relu": "ReLU inputs",
            "max_pool3d": "max-pool windows"}

    def __init__(self, key):
        import importlib
        self.patches = [(importlib.import_module(m), f)
                        for m, f in KINKS.get(key, ())]
        self.kept, self.order, self.flips, self.total = [], 0, {}, {}

    def taken(self, name, own):
        """The next recorded value in place of ``own``, counting where
        they differ."""
        want = self.kept[self.order].to(own.device)
        self.order += 1
        check(want.shape == own.shape, f"replayed {name} {tuple(want.shape)} "
                                       f"for {tuple(own.shape)}")
        self.flips[name] = self.flips.get(name, 0) + int((want != own).sum())
        self.total[name] = self.total.get(name, 0) + own.numel()
        return want

    def patched(self, name, real, recording):
        import torch.nn.functional as F
        if name == "max_pool3d":
            def pool(v, kernel, stride, padding):
                out, idx = F.max_pool3d(
                    (v if recording else v.detach()).permute(0, 4, 1, 2, 3),
                    kernel, stride, padding, return_indices=True)
                if recording:
                    self.kept.append(idx.cpu())
                    return out.permute(0, 2, 3, 4, 1)
                idx = self.taken(name, idx)
                b, c = idx.shape[:2]
                flat = v.permute(0, 4, 1, 2, 3).reshape(b, c, -1)
                return flat.gather(2, idx.reshape(b, c, -1)).reshape(
                    idx.shape).permute(0, 2, 3, 4, 1)
            return pool

        def kink(v, *args, **kwargs):
            if recording:
                self.kept.append((v.detach() > 0).cpu())
                return real(v, *args, **kwargs)
            side = self.taken(name, v.detach() > 0)
            return torch.where(side, v, 0.01 * v if name == "leaky_relu"
                               else torch.zeros((), dtype=v.dtype,
                                                device=v.device))
        return kink

    @contextlib.contextmanager
    def on(self, device):
        recording = device == "cuda"
        if recording:
            self.kept = []
        self.order, self.flips, self.total = 0, {}, {}
        real = [getattr(m, f) for m, f in self.patches]
        for (m, f), fn in zip(self.patches, real):
            setattr(m, f, self.patched(f, fn, recording))
        try:
            yield
        finally:
            for (m, f), fn in zip(self.patches, real):
                setattr(m, f, fn)
        check(recording or self.order == len(self.kept),
              f"the {device} run replayed {self.order} of {len(self.kept)} "
              f"recorded kinks and picks")

    def report(self):
        """The last replay's differences."""
        if not self.patches:
            return "no kink replayed"
        return (", ".join(f"{self.flips.get(f, 0)} of {self.total.get(f, 0)}"
                          f" {self.WHAT[f]}" for _, f in self.patches)
                + " fell on another side or picked another element on the "
                  "CPU (it took the card's)")


def without_dropout(model):
    """p = 0 on every dropout of a port model (layers and attention) and
    rate 0 on every drop-path."""
    from multi_modal_csi_tpu_torch.nn.layers import (DropPath, Dropout,
                                                     MultiheadAttention)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
        elif isinstance(m, MultiheadAttention):
            m.dropout = 0.0
        elif isinstance(m, DropPath):
            m.rate = 0.0
    return model


def training_data():
    """Seeded full-width windows and activity labels (one active user with
    one activity per window) for training and validation."""
    rng = np.random.default_rng(SEED)

    def windows(n):
        x = rng.standard_normal((n, LENGTH, CHANNELS), dtype=np.float32)
        y = np.zeros((n, 54), np.float32)
        y[np.arange(n), rng.integers(0, 54, size=n)] = 1.0
        return x, y

    return windows(TRAIN_WINDOWS) + windows(VALID_WINDOWS)


def train_rate(label, step, bx, by, gen, unit="windows"):
    """Windows (or clips) trained per second over TRAIN_RATE_STEPS steps,
    after the caller's warm-up step."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(TRAIN_RATE_STEPS):
        loss, _ = step(bx, by, gen)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    rate = TRAIN_RATE_STEPS * bx.shape[0] / elapsed
    print(f"{label}: {rate:.2f} {unit} trained/s at batch {bx.shape[0]} "
          f"({TRAIN_RATE_STEPS} steps in {elapsed * 1e3:.1f} ms, the "
          f"batch already on the card), last loss {float(loss):.4f}")
    check(math.isfinite(float(loss)), f"{label}: loss not finite")
    return rate


# K1's and K2's launch counts and K1's kernel name in the profile, by
# dtype
K1_COUNT = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention"}
K2_COUNT = {torch.float32: "flash_attention_backward",
            torch.bfloat16: "flash_attention_backward_bf16"}
K1_KERNEL = {torch.float32: K1_F32, torch.bfloat16: "tc::attention_kernel"}


def train_phase_that(data):
    """THAT training: one counted step in each dtype (f32, and bf16 as fit
    trains with train_dtype="bfloat16": the parameters and Adam's moments
    in bf16, each batch cast), its rate and profile with K1's and K2's
    shares, then the main path (fit, 2 f32 epochs) and one bf16 epoch.
    Returns the main path's launch counts and the bf16 epoch's."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS, build_model
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      cast_parameters, fit,
                                                      make_train_step)
    pytorch_defaults()
    cfg, spec = Config(), CSI_MODELS["THAT"]
    loss_fn = spec.make_loss(cfg, 54)
    x_tr, y_tr, x_va, y_va = data
    settings = dict(loss_fn=loss_fn, mode=spec.mode, lr=cfg.nn.lr,
                    batch_size=TRAIN_BATCH, seed=SEED,
                    weight_decay=spec.weight_decay,
                    threshold=cfg.nn.threshold, patience=cfg.nn.patience,
                    batch_axis=spec.batch_axis, augment=True)

    bx = torch.from_numpy(x_tr[:TRAIN_BATCH]).cuda()
    by = torch.from_numpy(y_tr[:TRAIN_BATCH]).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        name = DTYPE_NAMES[dtype]
        model = build_model("THAT", seed=SEED).cuda()
        cast_parameters(model, dtype)
        step = make_train_step(model, adam_like_torch(
            model.parameters(), cfg.nn.lr, spec.weight_decay), loss_fn,
            batch_dtype=dtype)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        step(bx, by, gen)                                     # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        step(bx, by, gen)
        torch.cuda.synchronize()
        one = dict(kernels.LAUNCH_COUNTS)
        print(f"THAT {name} training: launches in one step: {one}")
        check(one == {K1_COUNT[dtype]: 5, K2_COUNT[dtype]: 5},
              f"THAT {name} training step launched {one}, expected 5 K1 "
              f"and 5 K2")
        train_rate(f"THAT {name} training", step, bx, by, gen)
        prof = profile_device(f"THAT {name} training",
                              lambda: step(bx, by, gen), PROFILED_STEPS,
                              "step")
        k2 = {part: sum(t for key, t in prof["kernels"].items()
                        if kernel in key)
              for part, kernel in K2_PASSES[dtype].items()}
        print(f"THAT {name} training: K2 {sum(k2.values()):.3f} ms per step"
              f" (query pass {k2['query']:.3f}, dK/dV pass {k2['dkv']:.3f}),"
              f" {100 * sum(k2.values()) / prof['device_ms']:.1f}% of the "
              f"device time")
        check(all(k2.values()), f"THAT {name} training step ran no K2 pass")
        k1 = sum(t for key, t in prof["kernels"].items()
                 if K1_KERNEL[dtype] in key)
        print(f"THAT {name} training: K1 {k1:.3f} ms per step "
              f"({K1_KERNEL[dtype]}), {100 * k1 / prof['device_ms']:.1f}% of"
              f" the device time")
        check(k1 > 0, f"THAT {name} training step ran no K1 kernel")
        del model, step

    # the main path: fit, 2 epochs, f32
    model = build_model("THAT", seed=SEED)
    kernels.reset_launch_counts()
    start = time.perf_counter()
    res = fit(model, x_tr, y_tr, x_va, y_va, epochs=2, **settings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = dict(kernels.LAUNCH_COUNTS)
    steps = 2 * (math.ceil(TRAIN_WINDOWS / TRAIN_BATCH) - 1)
    for h in res.history:
        print(f"THAT fit epoch {h['epoch']}: train loss "
              f"{h['train_loss']:.4f}, validation loss {h['test_loss']:.4f},"
              f" F1 {h['f1_score']:.4f}, PPP "
              f"{h['perfect_prediction_percentage_test']:.1f}, "
              f"{h['epoch_time']:.2f} s")
    print(f"THAT fit: {steps} steps and 2 validation passes in {wall:.2f} s,"
          f" best epoch {res.best_epoch}; launches {launches}")
    check(res.epochs_ran == 2 and len(res.history) == 2,
          f"THAT fit ran {res.epochs_ran} epochs")
    check(all(math.isfinite(h[k]) for h in res.history
              for k in ("train_loss", "test_loss")),
          "THAT fit losses not finite")
    # 5 K2 per step; 5 K1 per step and per validation forward (one chunk
    # of VALID_WINDOWS a epoch)
    want = {"flash_attention_f32": 5 * steps + 5 * 2,
            "flash_attention_backward": 5 * steps}
    check(launches == want, f"THAT fit launched {launches}, expected {want}")
    del model

    model = build_model("THAT", seed=SEED)
    kernels.reset_launch_counts()
    res = fit(model, x_tr, y_tr, x_va, y_va, epochs=1,
              train_dtype="bfloat16", **settings)
    bf16 = dict(kernels.LAUNCH_COUNTS)
    h = res.history[0]
    print(f"THAT bf16 fit epoch: train loss {h['train_loss']:.4f}, "
          f"validation loss {h['test_loss']:.4f}, {h['epoch_time']:.2f} s; "
          f"launches {bf16}")
    check(all(p.dtype == torch.bfloat16 for p in model.parameters()),
          "THAT bf16 fit left parameters outside bf16")
    check(math.isfinite(h["train_loss"]) and math.isfinite(h["test_loss"]),
          "THAT bf16 fit losses not finite")
    check(bf16.get(K2_COUNT[torch.bfloat16]) == 5 * steps // 2
          and K2_COUNT[torch.float32] not in bf16
          and K1_COUNT[torch.float32] not in bf16,
          f"THAT bf16 fit launched {bf16}")
    return launches, bf16


def train_step_card_vs_cpu(key, x, y):
    """One f32 training step of ``key`` on windows ``x`` and labels ``y``
    on the card (default flags) and on the CPU, from the same seeded weights,
    augmentation and dropout off: the loss within STEP_F32_TOL relative,
    each gradient within GRAD_F32_TOL of its tensor's scale, each
    BatchNorm running statistic within STATS_F32_TOL of its buffer's
    largest magnitude.

    The scale is the tensor's largest CPU gradient, floored at 1e-2 of the
    model's largest: a conv bias feeding a training BatchNorm, or a
    LayerNorm bias feeding only such convs, has a zero gradient in exact
    arithmetic and float noise on both devices. The CPU takes the card's
    side at every leaky-ReLU kink (``KinkReplay``)."""
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS, build_model
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      make_train_step)
    pytorch_defaults()
    cfg, spec = Config(), CSI_MODELS[key]
    kinks = KinkReplay(key)
    got = {}
    for device in ("cuda", "cpu"):
        with kinks.on(device):
            model = without_dropout(build_model(key, seed=SEED)).to(device)
            step = make_train_step(model, adam_like_torch(
                model.parameters(), cfg.nn.lr, spec.weight_decay),
                spec.make_loss(cfg, y.shape[-1]), augment=False)
            loss, _ = step(torch.from_numpy(x).to(device),
                           torch.from_numpy(y).to(device),
                           torch.Generator(device=device).manual_seed(SEED))
        got[device] = (float(loss),
                       {n: p.grad.detach().cpu() for n, p
                        in model.named_parameters()},
                       {n: b.detach().cpu() for n, b in model.named_buffers()
                        if n.endswith(("running_mean", "running_var"))})
        del model, step
    (card_loss, card, card_stats), (cpu_loss, cpu, cpu_stats) = (
        got["cuda"], got["cpu"])
    floor = 1e-2 * max(g.abs().max().item() for g in cpu.values())
    worst = max((((card[n] - cpu[n]).abs().max().item()
                  / max(cpu[n].abs().max().item(), floor)), n) for n in cpu)
    stats = max((((card_stats[n] - cpu_stats[n]).abs().max().item()
                  / cpu_stats[n].abs().max().item()), n) for n in cpu_stats)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"{key} f32 training step, card vs CPU: {kinks.report()}; loss "
          f"{card_loss:.6f} vs {cpu_loss:.6f} (relative {rel:.2e}, "
          f"tolerance {STEP_F32_TOL}); worst gradient {worst[0]:.2e} of its "
          f"scale in {worst[1]} (tolerance {GRAD_F32_TOL}); worst BatchNorm "
          f"statistic {stats[0]:.2e} of its largest in {stats[1]} "
          f"(tolerance {STATS_F32_TOL})")
    check(rel <= STEP_F32_TOL, f"{key} card vs CPU step loss relative {rel}")
    check(worst[0] <= GRAD_F32_TOL, f"{key} card vs CPU gradient {worst}")
    check(stats[0] <= STATS_F32_TOL, f"{key} card vs CPU statistic {stats}")


def train_phase_baseline(key, data):
    """One WiMANS baseline trained in f32 at batch 16 at full width: no
    kernel launch in a step (none of the six attends, and training runs
    no int8), then ``fit`` for one epoch (augmentation on) over the
    seeded windows; the step's rate and profile are not timed
    (BASELINES)."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS, build_model
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch, fit,
                                                      make_train_step)
    start = time.perf_counter()
    pytorch_defaults()
    cfg, spec = Config(), CSI_MODELS[key]
    loss_fn = spec.make_loss(cfg, 54)
    x_tr, y_tr, x_va, y_va = data
    model = build_model(key, seed=SEED).cuda()
    step = make_train_step(model, adam_like_torch(
        model.parameters(), cfg.nn.lr, spec.weight_decay), loss_fn)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bx = torch.from_numpy(x_tr[:TRAIN_BATCH]).cuda()
    by = torch.from_numpy(y_tr[:TRAIN_BATCH]).cuda()
    step(bx, by, gen)                                         # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step(bx, by, gen)
    torch.cuda.synchronize()
    check(kernels.LAUNCH_COUNTS == {}, f"{key} training step launched "
                                       f"{dict(kernels.LAUNCH_COUNTS)}")
    del model, step, bx, by       # not timed: see BASELINES

    model = build_model(key, seed=SEED)
    kernels.reset_launch_counts()
    res = fit(model, x_tr, y_tr, x_va, y_va, loss_fn=loss_fn,
              mode=spec.mode, lr=cfg.nn.lr, epochs=1,
              batch_size=TRAIN_BATCH, seed=SEED,
              weight_decay=spec.weight_decay, threshold=cfg.nn.threshold)
    h = res.history[0]
    print(f"{key} fit epoch: train loss {h['train_loss']:.4f}, validation "
          f"loss {h['test_loss']:.4f}, F1 {h['f1_score']:.4f}, "
          f"{h['epoch_time']:.2f} s; launches {dict(kernels.LAUNCH_COUNTS)}")
    check(res.epochs_ran == 1 and math.isfinite(h["train_loss"])
          and math.isfinite(h["test_loss"]), f"{key} fit losses not finite")
    check(kernels.LAUNCH_COUNTS == {}, f"{key} fit launched "
                                       f"{dict(kernels.LAUNCH_COUNTS)}")
    del model
    torch.cuda.empty_cache()
    print(f"{key} training phase: {time.perf_counter() - start:.1f} s")


def train_phase_detr(data):
    """DETR's training step at the flagship configuration, batch 16,
    Hungarian matching loss, augmentation on: no kernel launch."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS, build_model
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      make_train_step)
    pytorch_defaults()
    cfg, spec = Config(), CSI_MODELS["DETR"]
    rng = np.random.default_rng(SEED)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (TRAIN_BATCH, 5))]
    model = build_model("DETR", seed=SEED).cuda()
    step = make_train_step(model, adam_like_torch(
        model.parameters(), cfg.nn.lr, spec.weight_decay),
        spec.make_loss(cfg, 10))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bx = torch.from_numpy(data[0][:TRAIN_BATCH]).cuda()
    by = torch.from_numpy(y).cuda()
    step(bx, by, gen)                                         # warm-up
    kernels.reset_launch_counts()
    train_rate("DETR f32 training", step, bx, by, gen)
    launches = dict(kernels.LAUNCH_COUNTS)
    print(f"DETR training: launches in {TRAIN_RATE_STEPS} steps: {launches}")
    check(launches == {}, f"DETR training launched {launches}")
    profile_device("DETR f32 training", lambda: step(bx, by, gen),
                   PROFILED_STEPS, "step")


def write_run_dataset(root, converted_amp):
    """annotation.csv of RUN_WINDOWS windows in one environment (absent
    users' cells empty) and the amplitude cache: the converted traces
    (act_0 ... act_3) and seeded windows of 2500 to 3000 steps."""
    from multi_modal_csi_tpu_torch.core.config import ACTIVITY_ENCODING
    rng = np.random.default_rng(SEED)
    amp_dir = os.path.join(root, "amp")
    os.makedirs(amp_dir, exist_ok=True)
    activities = [a for a in ACTIVITY_ENCODING if a != "nan"]
    header = ["label", "environment", "wifi_band", "number_of_users"] + [
        f"user_{u}_{what}" for u in range(1, 7)
        for what in ("location", "activity")]
    with open(os.path.join(root, "annotation.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        for i in range(RUN_WINDOWS):
            label = f"act_{i}" if i < TRACES else f"win_{i}"
            if i < TRACES:
                amp = np.load(os.path.join(converted_amp, f"{label}.npy"))
            else:
                t = int(rng.integers(2500, 3001))
                amp = np.abs(rng.standard_normal((t, 3, 3, 30),
                                                 dtype=np.float32))
            np.save(os.path.join(amp_dir, f"{label}.npy"), amp)
            users = int(rng.integers(0, 6))
            row = [label, "classroom", "5", str(users)]
            for u in range(6):
                row += ([str(rng.choice(list("abcde"))),
                         str(rng.choice(activities))] if u < users
                        else ["", ""])
            writer.writerow(row)
    return amp_dir


def run_csi_phase(work, converted_amp):
    """run_experiment at full width on the card for THAT_ENCODER and DETR
    (RUN_EPOCHS epochs, each saving its best weights as a component file
    under work/saved) and the WiMANS baselines MLP (the flat layout, the
    classification report) and CNN-1D (count_round; one epoch each): the
    result JSON, its keys, and the exact launch counts (none but
    THAT_ENCODER's K1 and K2). Returns THAT_ENCODER's launch counts."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.data.native_loader import native_available
    from multi_modal_csi_tpu_torch.data.splits import (env_split,
                                                       valid_test_split)
    from multi_modal_csi_tpu_torch.runners import csi as csi_runner
    from multi_modal_csi_tpu_torch.runners.csi import (CSI_MODELS,
                                                       run_experiment)
    from multi_modal_csi_tpu_torch.utils.logging import MetricWriter
    pytorch_defaults()
    check(native_available(), "the C++ window loader did not build")
    amp_dir = write_run_dataset(work, converted_amp)
    metrics_dir = os.path.join(work, "metrics")
    idx = np.arange(RUN_WINDOWS)
    out = {}
    for key, epochs in (("THAT_ENCODER", RUN_EPOCHS), ("DETR", RUN_EPOCHS),
                        ("MLP", 1), ("CNN-1D", 1)):
        spec = CSI_MODELS[key]
        n_train, rest = len(env_split(idx, idx)[0]), env_split(idx, idx)[1]
        if spec.valid_split:
            n_valid, n_test = (len(a) for a in
                               valid_test_split(rest, rest)[:2])
        else:                      # validation and test: the same 20%
            n_valid = n_test = len(rest)
        steps = epochs * (math.ceil(n_train / TRAIN_BATCH) - 1)
        # f32: the training steps and the validation chunks; bf16: the
        # final test pass in the serving dtype
        chunks = epochs * math.ceil(n_valid / 512)
        want = ({"flash_attention_f32": 5 * steps + 5 * chunks,
                 "flash_attention": 5 * math.ceil(n_test / 512),
                 "flash_attention_backward": 5 * steps}
                if key == "THAT_ENCODER" else {})
        keys = RESULT_KEYS - ({"final_metrics"}
                              if spec.final_eval == "report" else set())
        save = os.path.join(work, "results", f"{key}.json")
        cfg = Config().override({
            "model": key, "task": "activity", "repeat": 1,
            "path.data_x": amp_dir,
            "path.data_y": os.path.join(work, "annotation.csv"),
            "path.save": save, "data.environment": ["classroom"],
            "nn.epoch": epochs, "nn.batch_size": TRAIN_BATCH,
            "compute_dtype": "auto",
            # the transfer phase starts from these two runs' best weights
            "save_model": key in TRANSFER_KEYS,
            "saving_path": os.path.join(work, "saved")})
        writers = None
        if key == "THAT_ENCODER":
            os.makedirs(metrics_dir)

            def writers(name):
                return MetricWriter(os.path.join(metrics_dir,
                                                 f"{name}.jsonl"))
        kernels.reset_launch_counts()
        start = time.perf_counter()
        with recorded(csi_runner, ("fit", "load_csi_windows_native")) as calls:
            result = run_experiment(cfg, writer_factory=writers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = dict(kernels.LAUNCH_COUNTS)
        check(len(calls["load_csi_windows_native"]) == 1,
              f"{key} read its windows {len(calls['load_csi_windows_native'])}"
              f" times through the C++ loader, expected once")
        if writers is not None:
            check_metric_files(metrics_dir, key, result,
                               [res.history for res in calls["fit"]])
        with open(save) as f:
            written = json.load(f)
        fit_s = result["time_train"]["avg"]
        print(f"{key} run_experiment: {n_train} training, {n_valid} "
              f"validation, {n_test} test windows; {wall:.2f} s wall, fit "
              f"{fit_s:.2f} s ({steps} steps and {epochs} validation "
              f"passes: {steps * TRAIN_BATCH / fit_s:.1f} windows trained/s"
              f" over fit's wall time), final bf16 test pass "
              f"{result['time_test']['avg']:.3f} s; accuracy "
              f"{result['accuracy']['avg']:.1f}, parameters "
              f"{result['complexity']['parameter']}, forward FLOPs "
              f"{result['complexity']['flops']:.4g}; launches {launches}")
        check(set(written) == keys,
              f"{key} result JSON keys {sorted(written)}")
        check(written["model"] == key and written["nn"]["epoch"]
              == epochs and written["data"]["length"] == LENGTH,
              f"{key} result JSON config sections")
        check(all(math.isfinite(written[k]["avg"]) for k in
                  ("accuracy", "time_train", "time_test")),
              f"{key} result JSON values not finite")
        check(launches == want, f"{key} run launched {launches}, expected "
                                f"{want}")
        out[key] = launches
    return out["THAT_ENCODER"]


@contextlib.contextmanager
def recorded(module, names):
    """Record what each named function of ``module`` returns while the
    block runs (``calls[name]``), then restore the functions."""
    calls = {name: [] for name in names}
    saved = {name: getattr(module, name) for name in names}

    def recording(name):
        def call(*args, **kwargs):
            calls[name].append(saved[name](*args, **kwargs))
            return calls[name][-1]
        return call

    for name in names:
        setattr(module, name, recording(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


# the keys of fit's epoch record, JAX's (train/loop.py:425-439)
EPOCH_KEYS = {"epoch", "epoch_time", "train_loss", "test_loss",
              "total_error_test", "perfect_prediction_percentage_test",
              "perfect_prediction_percentage_train", "accuracy_test",
              "precision", "recall", "f1_score"}
AGGREGATE_KEYS = {"aggregate/accuracy_avg", "aggregate/accuracy_std",
                  "aggregate/time_train_avg", "aggregate/time_test_avg"}


def as_json(value):
    """``value`` as the JSONL file holds it (NaN compares equal there)."""
    return json.dumps(value, sort_keys=True,
                      default=lambda v: v.item())


def check_metric_files(metrics_dir, key, result, histories):
    """The JSONL files of a one-repeat run: ``<key>_0`` with an epoch
    record per epoch (``step`` the epoch, the rest fit's history entry)
    and then the summary, ``<key>_aggregate`` with the aggregate."""
    def read(name):
        with open(os.path.join(metrics_dir, f"{name}.jsonl")) as f:
            return [json.loads(line) for line in f]

    files = sorted(os.listdir(metrics_dir))
    check(files == [f"{key}_0.jsonl", f"{key}_aggregate.jsonl"],
          f"{key} metric files {files}")
    check(len(histories) == 1, f"{key} ran fit {len(histories)} times")
    *epochs, summary = read(f"{key}_0")
    check(len(epochs) == RUN_EPOCHS
          and all(set(r) == EPOCH_KEYS | {"_time", "step"} and
                  r["step"] == i for i, r in enumerate(epochs)),
          f"{key} epoch records {[sorted(r) for r in epochs]}")
    logged = [{k: v for k, v in r.items() if k in EPOCH_KEYS}
              for r in epochs]
    check(as_json(logged) == as_json(histories[0]),
          f"{key} epoch records {logged} differ from fit's history "
          f"{histories[0]}")
    check(summary.get("summary/test_accuracy") == result["accuracy"]["avg"]
          and "step" not in summary,
          f"{key} summary record {summary}, result accuracy "
          f"{result['accuracy']}")
    aggregate = read(f"{key}_aggregate")
    check(len(aggregate) == 1 and set(aggregate[0]) == AGGREGATE_KEYS
          | {"_time"} and aggregate[0]["aggregate/accuracy_avg"]
          == result["accuracy"]["avg"],
          f"{key} aggregate records {aggregate}")
    print(f"{key} metric writers: {len(epochs)} epoch records equal to "
          f"fit's history, summary test accuracy "
          f"{summary['summary/test_accuracy']!r}, aggregate accuracy "
          f"{aggregate[0]['aggregate/accuracy_avg']!r}; files {files}")


# ---------------------------------------------------------------------- #
# the multi-node launcher, run for real on one node of one card
# ---------------------------------------------------------------------- #

LAUNCHER = os.path.join("multi_modal_csi_tpu_torch", "jobs",
                        "gpu-multinode.sh")
LAUNCHER_TIMEOUT = 600     # seconds for the launcher's run to finish
LAUNCHER_TOL = 0.0         # its result's numbers against the in-process run,
                           # both with cuDNN's deterministic algorithms
# imported at the start of each of the launcher's Python processes (the
# torchrun agent and its rank): cuDNN's deterministic algorithms there too
DETERMINISTIC_SITE = ("import torch\n"
                      "torch.backends.cudnn.deterministic = True\n")


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms only while the block runs, the
    flag restored after: ``run_csi_phase``'s runs, which ``launcher_phase``
    holds the launcher's run to bit for bit. Under PyTorch's default a
    convolution's weight gradient may be summed with atomics in an order
    that changes from run to run, and two runs of one THAT_ENCODER config
    then differ in the trained weights and in some of the result's
    metrics."""
    previous = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = previous


def json_leaves(value, where=""):
    """(path, leaf) of every leaf of a result JSON, its wall times
    (``time_*``) left out."""
    if isinstance(value, dict):
        for key, item in value.items():
            if not key.startswith("time_"):
                yield from json_leaves(item, f"{where}.{key}")
    elif isinstance(value, list):
        for i, item in enumerate(value):
            yield from json_leaves(item, f"{where}[{i}]")
    else:
        yield where, value


def launcher_phase(work):
    """jobs/gpu-multinode.sh for real (module docstring, 10): one node of
    one card, its torchrun agent at a c10d rendezvous on 127.0.0.1, the
    rank in an NCCL group, running THAT_ENCODER on run_csi_phase's
    dataset with its config (save_model off, a result file of its own),
    with cuDNN's deterministic algorithms (a ``sitecustomize`` on the
    processes' PYTHONPATH sets the flag, as ``cudnn_deterministic`` sets it
    around run_csi_phase). The result JSON against run_csi_phase's
    THAT_ENCODER result: the same keys and every leaf but the wall times
    within LAUNCHER_TOL."""
    from multi_modal_csi_tpu_torch.kernels import build
    from multi_modal_csi_tpu_torch.parallel.mesh import free_port
    start = time.perf_counter()
    save = os.path.join(work, "results", "launcher.json")
    args = ["--repeat", "1"]
    for key, value in (
            ("path.data_x", os.path.join(work, "amp")),
            ("path.data_y", os.path.join(work, "annotation.csv")),
            ("path.save", save), ("data.environment", "classroom"),
            ("nn.epoch", RUN_EPOCHS), ("nn.batch_size", TRAIN_BATCH),
            ("compute_dtype", "auto"), ("save_model", "false")):
        args += ["--set", f"{key}={value}"]
    site = os.path.join(work, "launcher_site")
    os.makedirs(site, exist_ok=True)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(DETERMINISTIC_SITE)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = os.pathsep.join(
        [site] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env.update(NNODES="1", NPROC_PER_NODE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), RDZV_ID="chip-smoke",
               DATA_PATH=work, MODEL_TYPE="THAT_ENCODER", MAX_RESTARTS="0",
               PATH=os.pathsep.join([os.path.dirname(sys.executable),
                                     os.environ.get("PATH", "")]))
    built = {p.name: p.stat().st_mtime for p in build.BUILD_DIR.glob("*.so")}
    log_path = os.path.join(work, "launcher.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            ["bash", os.path.join(os.path.dirname(os.path.abspath(
                __file__)), LAUNCHER), *args], env=env, cwd=work,
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=LAUNCHER_TIMEOUT)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    with open(log_path) as f:
        tail = f.read().splitlines()[-12:]
    wall = time.perf_counter() - start
    print(f"launcher phase: {LAUNCHER} at NNODES=1 NPROC_PER_NODE=1 exited "
          f"{rc} after {wall:.1f} s; the end of its log:")
    for line in tail:
        print(f"  | {line[:300]}")
    check(rc == 0, f"the launcher exited {rc}")
    rebuilt = sorted(p.name for p in build.BUILD_DIR.glob("*.so")
                     if built.get(p.name) != p.stat().st_mtime)
    print(f"launcher phase: libraries the run built anew: "
          f"{rebuilt or 'none (every one loaded from the cached build)'}")
    with open(save) as f:
        got = json.load(f)
    with open(os.path.join(work, "results", "THAT_ENCODER.json")) as f:
        want = json.load(f)
    check(set(got) == set(want) == RESULT_KEYS,
          f"the launcher's result JSON keys {sorted(got)}")
    mine, theirs = dict(json_leaves(got)), dict(json_leaves(want))
    check(mine.keys() == theirs.keys(), f"the launcher's result leaves "
          f"{sorted(mine.keys() ^ theirs.keys())}")
    numbers = [(path, float(mine[path]), float(value))
               for path, value in theirs.items()
               if isinstance(value, (int, float))
               and not isinstance(value, bool)]
    diffs = [(abs(a - b), path, a, b) for path, a, b in numbers
             if not (a == b or (math.isnan(a) and math.isnan(b)))]
    others = [path for path, value in theirs.items()
              if not isinstance(value, (int, float)) and mine[path] != value]
    print(f"launcher phase: THAT_ENCODER accuracy {got['accuracy']['avg']!r} "
          f"(in process {want['accuracy']['avg']!r}); {len(numbers)} numbers "
          f"compared, {len(diffs)} differ"
          + (f", the largest by {max(diffs)[0]:.3e} at {max(diffs)[1]} "
             f"({max(diffs)[2]!r} vs {max(diffs)[3]!r})" if diffs else "")
          + f"; tolerance {LAUNCHER_TOL}; {time.perf_counter() - start:.1f}"
          f" s ({card_line()})")
    check(not others, f"the launcher's result differs at {others}")
    check(all(d <= LAUNCHER_TOL * max(1.0, abs(b)) for d, _, _, b in diffs),
          f"the launcher's result differs from the in-process run: "
          f"{sorted(diffs, reverse=True)[:5]}")


# ---------------------------------------------------------------------- #
# the ops layer: the C++ loader, the profiler trace, nan_guard, explore
# ---------------------------------------------------------------------- #

OPS_STEPS = 3              # THAT_ENCODER steps timed, and traced


def loader_seconds(load, amp_dir, labels):
    """Seconds of ``load(amp_dir, labels, LENGTH, threads)`` at 8 and at 1
    threads (the files already read: a warm page cache), and the
    windows."""
    times = {}
    for threads in (8, 1):
        start = time.perf_counter()
        out = load(amp_dir, labels, LENGTH, threads)
        times[threads] = time.perf_counter() - start
    return times, out


def trace_kernels(trace_dir):
    """The CUDA kernel events of the one Chrome trace under
    ``trace_dir``: their names and the device microseconds they sum to."""
    import glob
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    check(len(files) == 1, f"trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return [e["name"] for e in kernels], sum(e["dur"] for e in kernels)


def guarded_pass(model, x, y, loss_fn, seed):
    """One THAT_ENCODER forward and backward in training mode, dropout
    drawn from ``seed``: the logits, detached."""
    from multi_modal_csi_tpu_torch.core.device import cudnn_f32
    from multi_modal_csi_tpu_torch.nn.layers import dropout_generator
    model.zero_grad(set_to_none=True)
    with dropout_generator(torch.Generator(device="cuda").manual_seed(seed)):
        out = model(x)
    with cudnn_f32():
        loss_fn(out, y).backward()
    return out.detach()


def ops_phase(work):
    """The ops layer on the card at full width (module docstring, 10a).
    Returns the K1 f32 and K2 launches of its traced steps."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.data.annotation import load_annotation
    from multi_modal_csi_tpu_torch.data.csi_io import load_csi_windows
    from multi_modal_csi_tpu_torch.data.native_loader import (
        load_csi_windows_native, native_available)
    from multi_modal_csi_tpu_torch.kernels.flash_attention import (
        flash_attention_trainable)
    from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS, build_model
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      make_train_step)
    from multi_modal_csi_tpu_torch.utils import explore
    from multi_modal_csi_tpu_torch.utils.profiling import (StepTimer,
                                                           nan_guard, trace)
    phase_start = time.perf_counter()
    pytorch_defaults()
    amp_dir = os.path.join(work, "amp")
    annotation = load_annotation(os.path.join(work, "annotation.csv"))
    labels = list(annotation["label"])

    # the C++ loader against the numpy loader, bit for bit
    check(native_available(), "the C++ window loader did not build")
    native_s, native = loader_seconds(load_csi_windows_native, amp_dir,
                                      labels)
    numpy_s, plain = loader_seconds(load_csi_windows, amp_dir, labels)
    check(native.shape == plain.shape == (len(labels), LENGTH, 3, 3, 30)
          and np.array_equal(native, plain),
          f"C++ loader {native.shape} against numpy {plain.shape}: not "
          f"bit for bit")
    print(f"window loaders, {len(labels)} windows of ({LENGTH}, 3, 3, 30) "
          f"f32 ({native.nbytes / 2 ** 20:.1f} MiB, warm page cache): C++ "
          f"{native_s[8]:.4f} s at 8 threads, {native_s[1]:.4f} s at 1; "
          f"numpy {numpy_s[8]:.4f} s at 8, {numpy_s[1]:.4f} s at 1; bit for "
          f"bit equal ({card_line()})")
    del native, plain

    # THAT_ENCODER steps: a warm-up, OPS_STEPS timed, OPS_STEPS traced
    cfg = Config().override({"data.length": LENGTH})
    spec = CSI_MODELS["THAT_ENCODER"]
    loss_fn = spec.make_loss(cfg, 10)
    rng = np.random.default_rng(SEED + 13)
    bx = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, LENGTH, CHANNELS), dtype=np.float32)).cuda()
    by = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, (TRAIN_BATCH, 5))]).cuda()
    model = build_model("THAT_ENCODER", seed=SEED, cfg=cfg).cuda()
    step = make_train_step(model, adam_like_torch(
        model.parameters(), cfg.nn.lr, spec.weight_decay), loss_fn)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step(bx, by, gen)                                       # warm-up
    torch.cuda.synchronize()
    plain_timer = StepTimer()
    for _ in range(OPS_STEPS):
        plain_timer.start()
        plain_timer.stop(step(bx, by, gen))
    trace_dir = os.path.join(work, "trace")
    traced_timer = StepTimer()
    kernels.reset_launch_counts()
    with trace(trace_dir):
        for _ in range(OPS_STEPS):
            traced_timer.start()
            traced_timer.stop(step(bx, by, gen))
    launches = dict(kernels.LAUNCH_COUNTS)
    names, device_us = trace_kernels(trace_dir)
    seen = {"flash_attention_f32": sum(K1_F32 in n for n in names)}
    seen.update({f"flash_attention_backward ({part})":
                 sum(kernel in n for n in names)
                 for part, kernel in K2_PASSES[torch.float32].items()})
    plain, traced = plain_timer.summary(), traced_timer.summary()
    print(f"THAT_ENCODER steps at batch {TRAIN_BATCH}: StepTimer outside the"
          f" trace {plain}; inside {traced} (profiler overhead "
          f"{traced['mean_s'] / plain['mean_s'] - 1:+.1%} of the mean); the"
          f" trace's {len(names)} kernels {device_us / 1e3 / OPS_STEPS:.3f} "
          f"device ms a step; hand kernels in the trace {seen}, launches "
          f"counted {launches} ({card_line()})")
    want = {"flash_attention_f32": 5 * OPS_STEPS,
            "flash_attention_backward": 5 * OPS_STEPS}
    check(launches == want, f"traced steps launched {launches}, expected "
                            f"{want}")
    check(seen == {"flash_attention_f32": want["flash_attention_f32"],
                   **{f"flash_attention_backward ({part})":
                      want["flash_attention_backward"]
                      for part in K2_PASSES[torch.float32]}},
          f"the trace holds {seen} hand kernels, the steps launched "
          f"{launches}")

    # nan_guard: a clean forward and backward, bit-equal and timed
    x, y = bx[:TRAIN_BATCH], by[:TRAIN_BATCH]
    times = {}
    for label in ("plain", "guarded", "plain again"):
        with nan_guard() if label == "guarded" else contextlib.nullcontext():
            guarded_pass(model, x, y, loss_fn, SEED)          # warm
            torch.cuda.synchronize()
            start = time.perf_counter()
            logits = guarded_pass(model, x, y, loss_fn, SEED)
            torch.cuda.synchronize()
        times[label] = time.perf_counter() - start
        if label == "plain":
            want_logits = logits
        check(torch.equal(logits, want_logits),
              f"nan_guard: {label} logits differ from the plain pass's")
    print(f"nan_guard on a THAT_ENCODER forward and backward at batch "
          f"{TRAIN_BATCH}: logits bit-equal to the plain pass; "
          f"{times['guarded'] * 1e3:.1f} ms against "
          f"{times['plain'] * 1e3:.1f} / {times['plain again'] * 1e3:.1f} ms"
          f" plain (+{(times['guarded'] - times['plain']) * 1e3:.1f} ms a "
          f"step; {card_line()})")
    # a NaN in one input window: raised at the first op that reads it
    x_nan = x.clone()
    x_nan[3, LENGTH // 2, 100] = float("nan")
    try:
        with nan_guard():
            guarded_pass(model, x_nan, y, loss_fn, SEED)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    print(f"nan_guard with a NaN in window 3: {raised!r}")
    check(raised is not None and "output of aten." in raised,
          f"nan_guard let a NaN input through ({raised!r})")
    # a NaN in the gradient fed to K2: named at K2's launch, which runs on
    # the autograd engine's device thread
    q, k, v = (torch.randn((TRAIN_BATCH, 270, 10, 27), device="cuda",
                           requires_grad=True) for _ in range(3))
    do = torch.randn((TRAIN_BATCH, 270, 10, 27), device="cuda")
    do[0, 0, 0, 0] = float("nan")
    kernels.reset_launch_counts()
    try:
        with nan_guard():
            flash_attention_trainable(q, k, v).backward(do)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    print(f"nan_guard with a NaN in K2's output gradient: {raised!r}; "
          f"launches {dict(kernels.LAUNCH_COUNTS)}")
    check(raised == "nan_guard: NaN in the output of the "
                    "flash_attention_backward kernel",
          f"nan_guard did not name K2 ({raised!r})")

    # explore on 10's dataset
    stats = explore.packet_loss_stats(amp_dir, labels, LENGTH)
    dist = explore.label_distribution(annotation)
    print(f"explore: packet_loss_stats {stats}; label_distribution {dist}")
    check(stats["num_windows"] == len(labels)
          and stats["max_length"] <= LENGTH
          and sum(dist["number_of_users"].values()) == len(labels),
          f"explore: {stats}, {dist}")
    import importlib.util
    heatmap = os.path.join(work, "plots", "heatmap.png")
    window = np.load(os.path.join(amp_dir, f"{labels[0]}.npy"))
    if importlib.util.find_spec("matplotlib") is None:
        try:
            explore.csi_heatmap(window, heatmap)
            raised = None
        except ImportError as e:
            raised = str(e)
        print(f"explore.csi_heatmap without matplotlib: {raised!r}")
        check(raised is not None and "matplotlib" in raised,
              f"csi_heatmap without matplotlib raised {raised!r}")
    else:
        explore.csi_heatmap(window, heatmap)
        check(os.path.getsize(heatmap) > 0, "csi_heatmap wrote no PNG")
        print(f"explore.csi_heatmap wrote {heatmap}")
    print(f"ops phase: {time.perf_counter() - phase_start:.1f} s")


# ---------------------------------------------------------------------- #
# checkpoints, transfer learning, resume, SSL, dual band and ST-RF
# ---------------------------------------------------------------------- #

TRANSFER_KEYS = ("THAT_ENCODER", "DETR")
TRANSFER_PARTS = ("feature_extractor", "encoder")   # feature_encoder's
SSL_STEP_BATCH = 8         # card vs CPU: the projector's BatchNorms
                           # normalise by the batch's own statistics
STRF_WINDOWS = 16
STRF_REL = 1e-4            # card (torch.fft) vs host scipy, of the largest


def run_counts(key, epochs, n_windows=RUN_WINDOWS):
    """The exact launch counts of run_experiment for ``key`` over the
    phase's dataset: K1 f32 in the training steps and validation passes,
    K1 bf16 in the final test pass, K2 in the steps (THAT_ENCODER only).
    Returns (training windows, steps, counts)."""
    from multi_modal_csi_tpu_torch.data.splits import (env_split,
                                                       valid_test_split)
    idx = np.arange(n_windows)
    n_train, rest = len(env_split(idx, idx)[0]), env_split(idx, idx)[1]
    n_valid, n_test = (len(a) for a in valid_test_split(rest, rest)[:2])
    steps = epochs * (math.ceil(n_train / TRAIN_BATCH) - 1)
    want = ({"flash_attention_f32": 5 * steps
             + 5 * epochs * math.ceil(n_valid / 512),
             "flash_attention": 5 * math.ceil(n_test / 512),
             "flash_attention_backward": 5 * steps}
            if key == "THAT_ENCODER" else {})
    return n_train, steps, want


def moved(after, before, part, stats=False):
    """Whether any of ``part``'s parameters (or, with ``stats``, its
    BatchNorm running statistics) differ between two state dicts."""
    names = [k for k in before if k.split(".")[0] == part
             and ("running_" in k) == stats]
    check(bool(names), f"no {'statistics' if stats else 'parameters'} "
                       f"under {part}")
    return any(not torch.equal(after[k], before[k].cpu()) for k in names)


def transfer_phase(work):
    """Transfer learning at full width from run_csi_phase's component
    files (work/saved). For THAT_ENCODER and DETR: the file restored under
    feature_encoder into the weights of seed 0 (the feature extractor and
    encoder equal to the file's bit for bit, the rest to the fresh
    weights); for THAT_ENCODER one counted training step with
    transfer_optimizer (exactly 5 K1 f32 and 5 K2 launches) and its
    profile with K1's and K2's shares; then run_experiment under
    feature_encoder (THAT_ENCODER RUN_EPOCHS epochs, DETR one), saving its
    best weights: the result JSON's keys, the exact launch counts, and the
    saved weights against the restored ones (THAT_ENCODER's encoder and
    decoder moved; DETR's frozen feature extractor bit-equal while its
    BatchNorm statistics moved, its encoder and decoder moved). Returns
    THAT_ENCODER's launch counts."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.checkpoint import (component_path,
                                                           restore_scenario)
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.runners.csi import (CSI_MODELS,
                                                       run_experiment)
    from multi_modal_csi_tpu_torch.train.loop import make_train_step
    from multi_modal_csi_tpu_torch.train.transfer import transfer_optimizer
    pytorch_defaults()
    phase_start = time.perf_counter()
    out = {}
    for key, epochs in (("THAT_ENCODER", RUN_EPOCHS), ("DETR", 1)):
        spec, cfg = CSI_MODELS[key], Config()
        saved = component_path(os.path.join(work, "saved"), ["classroom"],
                               key)
        file_state = torch.load(saved, map_location="cpu", weights_only=True)
        fresh = spec.build((LENGTH, CHANNELS), 10, cfg,
                           torch.Generator().manual_seed(0)).state_dict()
        start = restore_scenario(
            spec.build((LENGTH, CHANNELS), 10, cfg,
                       torch.Generator().manual_seed(0)),
            saved, "feature_encoder", key)
        start_state = {k: v.clone() for k, v in start.state_dict().items()}
        for name, value in start_state.items():
            src = (file_state if name.split(".")[0] in TRANSFER_PARTS
                   else fresh)
            check(torch.equal(value, src[name]),
                  f"{key} feature_encoder restore of {name}")
        print(f"{key} feature_encoder: {len(start_state)} entries restored "
              f"from {os.path.basename(saved)}, "
              f"{sum(k.split('.')[0] in TRANSFER_PARTS for k in start_state)}"
              f" of them the file's, bit for bit")

        if key == "THAT_ENCODER":
            model = start.cuda()
            step = make_train_step(model, transfer_optimizer(
                model, cfg.nn.lr, "feature_encoder"),
                spec.make_loss(cfg, 10))
            rng = np.random.default_rng(SEED + 7)
            bx = torch.from_numpy(rng.standard_normal(
                (TRAIN_BATCH, LENGTH, CHANNELS), dtype=np.float32)).cuda()
            by = torch.from_numpy(np.eye(10, dtype=np.float32)[
                rng.integers(0, 10, (TRAIN_BATCH, 5))]).cuda()
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            step(bx, by, gen)                                 # warm-up
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            step(bx, by, gen)
            torch.cuda.synchronize()
            one = dict(kernels.LAUNCH_COUNTS)
            print(f"THAT_ENCODER feature_encoder training: launches in one "
                  f"step: {one}")
            check(one == {"flash_attention_f32": 5,
                          "flash_attention_backward": 5},
                  f"THAT_ENCODER transfer step launched {one}")
            prof = profile_device("THAT_ENCODER feature_encoder training",
                                  lambda: step(bx, by, gen),
                                  PROFILED_STEPS, "step")
            k1 = sum(t for name, t in prof["kernels"].items()
                     if K1_F32 in name)
            k2 = sum(t for name, t in prof["kernels"].items()
                     if any(part in name for part in
                            K2_PASSES[torch.float32].values()))
            print(f"THAT_ENCODER feature_encoder training: K1 {k1:.3f} ms "
                  f"({100 * k1 / prof['device_ms']:.1f}%), K2 {k2:.3f} ms "
                  f"({100 * k2 / prof['device_ms']:.1f}%) of "
                  f"{prof['device_ms']:.3f} ms device time per step")
            check(k1 > 0 and k2 > 0, "THAT_ENCODER transfer step ran no "
                                     "K1 or K2 kernel")
            del model, step, bx, by

        n_train, steps, want = run_counts(key, epochs)
        results = os.path.join(work, "transfer")
        save = os.path.join(results, f"{key}.json")
        cfg = Config().override({
            "model": key, "task": "activity", "repeat": 1,
            "path.data_x": os.path.join(work, "amp"),
            "path.data_y": os.path.join(work, "annotation.csv"),
            "path.save": save, "data.environment": ["classroom"],
            "nn.epoch": epochs, "nn.batch_size": TRAIN_BATCH,
            "compute_dtype": "auto", "pretrained_path": saved,
            "transfer_scenario": "feature_encoder", "save_model": True,
            "saving_path": results})
        kernels.reset_launch_counts()
        start_s = time.perf_counter()
        result = run_experiment(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start_s
        launches = dict(kernels.LAUNCH_COUNTS)
        with open(save) as f:
            written = json.load(f)
        print(f"{key} run_experiment under feature_encoder: {n_train} "
              f"training windows, {steps} steps; {wall:.2f} s wall, fit "
              f"{result['time_train']['avg']:.2f} s; accuracy "
              f"{result['accuracy']['avg']:.1f}; launches {launches}")
        check(set(written) == RESULT_KEYS,
              f"{key} transfer result JSON keys {sorted(written)}")
        check(launches == want, f"{key} transfer run launched {launches}, "
                                f"expected {want}")
        best = torch.load(component_path(results, ["classroom"], key),
                          map_location="cpu", weights_only=True)
        check(set(best) == set(start_state), f"{key} saved keys")
        if key == "DETR":
            frozen = [k for k in start_state
                      if k.startswith("feature_extractor.")
                      and "running_" not in k]
            check(all(torch.equal(best[k], start_state[k]) for k in frozen),
                  "DETR's frozen feature extractor moved")
            check(moved(best, start_state, "feature_extractor", stats=True),
                  "DETR's frozen feature extractor kept its BatchNorm "
                  "statistics")
        for part in ("encoder", "decoder"):
            check(moved(best, start_state, part),
                  f"{key} transfer run left the {part} as restored")
        out[key] = launches
    print(f"transfer phase: {time.perf_counter() - phase_start:.1f} s")
    return out["THAT_ENCODER"]


def resume_phase(data, work):
    """THAT fit at batch 16, f32, with the cosine-warmup schedule and a
    run checkpoint each epoch: 2 epochs, then the checkpoint restored into
    a fresh model, Adam and schedule as fit builds them (the weights and
    BatchNorm buffers, Adam's step and moments, the schedule's step and
    learning rate, bit for bit), then fit with epochs=3 on the same
    directory, which trains exactly one epoch (epoch 2; 5 K1 f32 and 5 K2
    a step). Returns both fits' launch counts, summed."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.checkpoint import RunCheckpointer
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS, build_model
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch, fit,
                                                      restore_model, resume)
    from multi_modal_csi_tpu_torch.train.schedules import cosine_warmup
    pytorch_defaults()
    phase_start = time.perf_counter()
    cfg, spec = Config(), CSI_MODELS["THAT"]
    x_tr, y_tr, x_va, y_va = data
    directory = os.path.join(work, "run_checkpoints")
    steps = math.ceil(TRAIN_WINDOWS / TRAIN_BATCH) - 1
    settings = dict(loss_fn=spec.make_loss(cfg, 54), mode=spec.mode,
                    lr=cfg.nn.lr, batch_size=TRAIN_BATCH, seed=SEED,
                    weight_decay=spec.weight_decay,
                    threshold=cfg.nn.threshold, patience=cfg.nn.patience,
                    use_cosine_schedule=True, warmup_epochs=1,
                    min_lr_ratio=cfg.nn.scheduler.min_lr_ratio,
                    checkpoint_dir=directory, checkpoint_every=1)
    model = build_model("THAT", seed=SEED)
    kernels.reset_launch_counts()
    first = fit(model, x_tr, y_tr, x_va, y_va, epochs=2, **settings)
    launches = dict(kernels.LAUNCH_COUNTS)
    ckpt = RunCheckpointer(directory)
    check(first.epochs_ran == 2 and ckpt.latest_step() == 1,
          f"THAT fit with checkpoints ran {first.epochs_ran} epochs, "
          f"newest checkpoint {ckpt.latest_step()}")
    state = ckpt.restore()
    live = model.state_dict()
    check(all(torch.equal(live[k].cpu(), v)
              for k, v in state["model"].items()),
          "the run checkpoint differs from the run's last weights")

    other = build_model("THAT", seed=SEED + 1).cuda()
    opt = adam_like_torch(other.parameters(), cfg.nn.lr, spec.weight_decay)
    schedule = cosine_warmup(steps, 3 * steps,
                             cfg.nn.scheduler.min_lr_ratio)
    scheduler = torch.optim.lr_scheduler.LambdaLR(opt, schedule)
    restore_model(state, other)
    epoch = resume(state, opt, scheduler)
    restored = other.state_dict()
    moments = opt.state_dict()["state"]
    saved_moments = state["optimizer"]["state"]
    check(epoch == 1 and all(torch.equal(restored[k].cpu(), v)
                             for k, v in state["model"].items()),
          "resume restored other weights")
    check(set(moments) == set(saved_moments) and all(
        torch.equal(moments[i][name].cpu(), saved_moments[i][name])
        for i in moments for name in ("step", "exp_avg", "exp_avg_sq")),
        "resume restored other Adam moments")
    lr = opt.param_groups[0]["lr"]
    check(scheduler.last_epoch == 2 * steps
          and lr == cfg.nn.lr * schedule(2 * steps),
          f"resume restored the schedule at step {scheduler.last_epoch}, "
          f"lr {lr}")
    print(f"THAT run checkpoint (epoch {epoch}): {len(restored)} weights "
          f"and buffers, {len(moments)} Adam states (step "
          f"{float(next(iter(moments.values()))['step']):.0f}) and the "
          f"schedule at step {scheduler.last_epoch} (lr {lr:.3e}) restored "
          f"bit for bit")
    del other, opt, scheduler

    kernels.reset_launch_counts()
    again = fit(build_model("THAT", seed=SEED), x_tr, y_tr, x_va, y_va,
                epochs=3, **settings)
    torch.cuda.synchronize()
    resumed = dict(kernels.LAUNCH_COUNTS)
    h = again.history
    print(f"THAT fit resumed to 3 epochs: trained epochs "
          f"{[r['epoch'] for r in h]}, train loss "
          f"{h[0]['train_loss']:.4f}, validation loss "
          f"{h[0]['test_loss']:.4f}; launches {resumed}")
    want = {"flash_attention_f32": 5 * steps + 5,
            "flash_attention_backward": 5 * steps}
    check([r["epoch"] for r in h] == [2] and math.isfinite(
        h[0]["train_loss"]), "the resumed fit did not train epoch 2 alone")
    check(resumed == want, f"resumed THAT fit launched {resumed}, expected "
                           f"{want}")
    check(ckpt.latest_step() == 2, "the resumed fit saved no checkpoint")
    print(f"resume phase: {time.perf_counter() - phase_start:.1f} s")
    return {k: launches.get(k, 0) + resumed.get(k, 0)
            for k in set(launches) | set(resumed)}


def ssl_phase(data, work):
    """SSL at full width: run_ssl for one epoch at batch 16 (every batch,
    the random views), saving its weights, then cli/ssl_inference.py on
    the saved file over run_csi_phase's dataset; no kernel launch; the
    training rate and a profile of the step; then one f32 step with fixed
    views at batch 8 on the card against the CPU: the loss, each
    gradient and each BatchNorm statistic."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.cli import ssl_inference
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.core.device import cudnn_f32
    from multi_modal_csi_tpu_torch.models.csi.ssl import ssl_loss, two_views
    from multi_modal_csi_tpu_torch.nn.layers import dropout_generator
    from multi_modal_csi_tpu_torch.runners.ssl import build_ssl, run_ssl
    from multi_modal_csi_tpu_torch.train.loop import adam_like_torch
    pytorch_defaults()
    phase_start = time.perf_counter()
    x_tr, y_tr, x_va, y_va = data
    cfg = Config().override({"repeat": 1, "nn.epoch": 1,
                             "nn.batch_size": TRAIN_BATCH})
    save = os.path.join(work, "ssl", "ssl.pt")
    history = []
    kernels.reset_launch_counts()
    result = run_ssl(cfg, (x_tr, x_va, y_tr, y_va), save_path=save,
                     history=history)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCH_COUNTS)
    fit_s = result["time_train"]["avg"]
    print(f"SSL run_ssl: {len(x_tr)} windows, one epoch at batch "
          f"{TRAIN_BATCH} in {fit_s:.2f} s ({len(x_tr) / fit_s:.1f} windows "
          f"trained/s over the epoch's wall time, the one-batch evaluation "
          f"included), loss {history[0]['train_loss']:.4f}, test accuracy "
          f"{result['accuracy']['avg']:.3f}; launches {launches}")
    check(launches == {}, f"run_ssl launched {launches}")
    check(set(result) == {"repeat_0", "accuracy", "time_train", "time_test"}
          and math.isfinite(history[0]["train_loss"]),
          f"run_ssl result {sorted(result)}")
    with contextlib.redirect_stdout(None):     # the report's JSON
        out = ssl_inference.main([
            "--checkpoint", save, "--set", f"path.data_x={work}/amp",
            "--set", f"path.data_y={work}/annotation.csv",
            "--set", "data.environment=classroom"])
    print(f"SSL ssl_inference on the saved file: test accuracy "
          f"{out['accuracy']:.3f}, {len(out['report'])} report rows")
    check(0.0 <= out["accuracy"] <= 1.0 and "micro avg" in out["report"],
          "ssl_inference result")

    model = build_ssl(54, SEED, CHANNELS).cuda()
    opt = adam_like_torch(model.parameters(), cfg.nn.lr)

    def step(bx, by, gen):
        model.train()
        v1, v2 = two_views(gen, bx)
        opt.zero_grad(set_to_none=True)
        with dropout_generator(gen):
            loss, _ = ssl_loss(*model(v1, v2), by)
        with cudnn_f32():                  # as runners/ssl.py's step
            loss.backward()
        opt.step()
        return loss.detach(), None

    bx = torch.from_numpy(x_tr[:TRAIN_BATCH]).cuda()
    by = torch.from_numpy(y_tr[:TRAIN_BATCH]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step(bx, by, gen)                                         # warm-up
    train_rate("SSL f32 training", step, bx, by, gen)
    profile_device("SSL f32 training", lambda: step(bx, by, gen),
                   PROFILED_STEPS, "step")
    del model, opt, bx, by

    pytorch_defaults()
    x = x_tr[:SSL_STEP_BATCH]
    y = y_tr[:SSL_STEP_BATCH]
    got = {}
    for device in ("cuda", "cpu"):
        model = without_dropout(build_ssl(54, SEED, CHANNELS)).to(
            device).train()
        bx = torch.from_numpy(x).to(device)
        loss, _ = ssl_loss(*model(bx, bx * 0.9 + 0.1),
                           torch.from_numpy(y).to(device))
        with cudnn_f32():                  # as the port's training steps
            loss.backward()
        got[device] = (float(loss),
                       {n: p.grad.cpu() for n, p in model.named_parameters()},
                       {n: b.cpu() for n, b in model.named_buffers()})
        del model, bx
    (card_loss, card, card_stats), (cpu_loss, cpu, cpu_stats) = (
        got["cuda"], got["cpu"])
    floor = 1e-2 * max(g.abs().max().item() for g in cpu.values())
    worst = max((((card[n] - cpu[n]).abs().max().item()
                  / max(cpu[n].abs().max().item(), floor)), n) for n in cpu)
    stats = max((((card_stats[n] - cpu_stats[n]).abs().max().item()
                  / cpu_stats[n].abs().max().item()), n) for n in cpu_stats)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"SSL f32 training step at batch {SSL_STEP_BATCH}, fixed views, "
          f"card vs CPU: loss {card_loss:.6f} vs {cpu_loss:.6f} (relative "
          f"{rel:.2e}, tolerance {STEP_F32_TOL}); worst gradient "
          f"{worst[0]:.2e} of its scale in {worst[1]} (tolerance "
          f"{GRAD_F32_TOL}); worst BatchNorm statistic {stats[0]:.2e} of its"
          f" largest in {stats[1]} (tolerance {STATS_F32_TOL})")
    check(rel <= STEP_F32_TOL, f"SSL card vs CPU step loss relative {rel}")
    check(worst[0] <= GRAD_F32_TOL, f"SSL card vs CPU gradient {worst}")
    check(stats[0] <= STATS_F32_TOL, f"SSL card vs CPU statistic {stats}")
    print(f"SSL phase: {time.perf_counter() - phase_start:.1f} s")


def dual_band_phase(data):
    """dual_band at full width: run_csi_model for one epoch at batch 16 on
    (80, 2, 3000, 270) paired windows (band 2 other windows than band 1),
    no kernel launch; the f32 forward on the card against the CPU at
    batch 2 (default flags) within SERVE_F32_TOL; profiles of the f32 forward
    and training step at batch 16."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
    from multi_modal_csi_tpu_torch.runners.csi import run_csi_model
    from multi_modal_csi_tpu_torch.runners.dual_band import build_dual_band
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      make_train_step)
    pytorch_defaults()
    phase_start = time.perf_counter()
    x_tr, y_tr, x_va, y_va = data

    def paired(x):
        return np.stack([x, x[::-1]], axis=1)

    cfg = Config().override({"model": "dual_band", "repeat": 1,
                             "nn.epoch": 1, "nn.batch_size": TRAIN_BATCH})
    kernels.reset_launch_counts()
    result = run_csi_model(cfg, (paired(x_tr), paired(x_va), y_tr, y_va))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCH_COUNTS)
    steps = math.ceil(TRAIN_WINDOWS / TRAIN_BATCH) - 1
    print(f"dual_band run: {steps} steps of (16, 2, 3000, 270) and the "
          f"validation pass in {result['time_train']['avg']:.2f} s, test "
          f"accuracy {result['accuracy']['avg']:.3f}; launches {launches}")
    check(launches == {}, f"dual_band launched {launches}")
    check(set(result) == {"repeat_0", "accuracy", "time_train", "time_test"}
          and math.isfinite(result["accuracy"]["avg"]),
          f"dual_band result {sorted(result)}")

    pytorch_defaults()
    x = paired(x_va[:4])[:2]
    model = build_dual_band(54, SEED, CHANNELS).eval()
    with torch.no_grad():
        cpu = model(torch.from_numpy(x)).numpy()
        model.cuda()
        card = model(torch.from_numpy(x).cuda()).cpu().numpy()
    err = float(np.abs(card - cpu).max())
    print(f"dual_band f32 card vs CPU: max abs err {err:.3e} = "
          f"{err / np.abs(cpu).max():.2e} of the largest logit (tolerance "
          f"{SERVE_F32_TOL} abs + rel)")
    check(np.allclose(card, cpu, atol=SERVE_F32_TOL, rtol=SERVE_F32_TOL),
          f"dual_band f32 card vs CPU err {err}")

    bx = torch.from_numpy(paired(x_tr[:TRAIN_BATCH])).cuda()
    by = torch.from_numpy(y_tr[:TRAIN_BATCH]).cuda()
    with torch.no_grad():
        profile_device("dual_band f32 forward", lambda: model(bx),
                       PROFILED_FORWARDS, "forward")
    step = make_train_step(model, adam_like_torch(model.parameters(),
                                                  cfg.nn.lr),
                           lambda o, t: bce_with_logits(o, t, 6.0))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step(bx, by, gen)                                         # warm-up
    train_rate("dual_band f32 training", step, bx, by, gen)
    profile_device("dual_band f32 training", lambda: step(bx, by, gen),
                   PROFILED_STEPS, "step")
    del model, step, bx, by
    torch.cuda.empty_cache()
    print(f"dual_band phase: {time.perf_counter() - phase_start:.1f} s")


def strf_phase(data):
    """ST-RF: kernels/spectrogram.py::strf_features on the card against
    models/csi/strf.py's scipy features on the host at (16, 3000, 270),
    within STRF_REL of the largest feature, with both times; then the
    runner's ST-RF path, which computes the same features on the card:
    where sklearn imports it runs, and where it does not run_csi_model
    must raise the ImportError that names sklearn."""
    import importlib.util
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.kernels.spectrogram import strf_features
    from multi_modal_csi_tpu_torch.models.csi.strf import (
        spectrogram_features)
    from multi_modal_csi_tpu_torch.runners.csi import run_csi_model
    x, y = data[0][:STRF_WINDOWS], data[1][:STRF_WINDOWS]
    start = time.perf_counter()
    host = spectrogram_features(x)
    host_s = time.perf_counter() - start
    xd = torch.from_numpy(x).cuda()
    card = strf_features(xd).cpu().numpy()
    ms = cuda_ms(lambda: strf_features(xd), reps=10)
    err = float(np.abs(card - host).max() / np.abs(host).max())
    print(f"ST-RF features {tuple(host.shape)} of {x.shape}: card "
          f"{ms:.3f} ms (torch.fft), host scipy {host_s * 1e3:.1f} ms; "
          f"max abs difference {err:.2e} of the largest feature (tolerance "
          f"{STRF_REL})")
    check(card.shape == host.shape and err <= STRF_REL,
          f"ST-RF features card vs host {err}")
    cfg = Config().override({"model": "ST-RF", "repeat": 1})
    split = (x[:12], x[12:], y[:12], y[12:])
    if importlib.util.find_spec("sklearn") is None:
        try:
            run_csi_model(cfg, split)
        except ImportError as e:
            print(f"ST-RF runner without sklearn: ImportError: {e}")
            check("sklearn" in str(e), f"ST-RF raised {e!r}")
        else:
            check(False, "ST-RF ran where sklearn does not import")
    else:
        result = run_csi_model(cfg, split)
        print(f"ST-RF runner: accuracy {result['accuracy']['avg']:.3f}")
        check(math.isfinite(result["accuracy"]["avg"]), "ST-RF result")


def lowrank_bound(shape, bias, dtype):
    """The least times (ms) one K3 call needs on an H100 SXM: q, k, v, r
    and s read once and out and the LSE written once over the HBM rate;
    the QK^T and PV products (4 B*H*Nq*Nk*D) over the peak of the dtype
    plus the bias product (2 B*H*Nq*Nk*M): in f32 over the f32 peak, in
    bf16 as the kernel computes it, three TF32 products (3xTF32) over the
    TF32 tensor-core peak. The third time is the operations bound with
    every f32 product as 3xTF32 (3 x operations over the TF32 peak; the
    f32 kernel computes QK^T and P.V so, the bias on the CUDA cores); in
    bf16 it is the second."""
    b, h, nq, nk, d, m = shape
    m = m if bias else 0
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * nq * d + 2 * b * h * nk * d) * item + 4 * (
        b * h * nq * m + m * nk + b * h * nq)
    bias_ms = (2.0 * b * h * nq * nk * m / PEAK_FLOPS[torch.float32]
               if dtype == torch.float32 else
               3 * 2.0 * b * h * nq * nk * m / PEAK_TF32)
    ops_ms = 1e3 * (4.0 * b * h * nq * nk * d / PEAK_FLOPS[dtype] + bias_ms)
    tf32_ms = (1e3 * 3 * (4.0 * d + 2.0 * m) * b * h * nq * nk / PEAK_TF32
               if dtype == torch.float32 else ops_ms)
    return 1e3 * nbytes / PEAK_BYTES, ops_ms, tf32_ms


def sdpa_kernels(label, q, k, v, mask):
    """The CUDA kernels one scaled_dot_product_attention call runs (the
    backend PyTorch picks), by device time, from torch.profiler."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    print(f"sdpa {label} kernels: " + "; ".join(
        f"{e.key[:80]} {e.self_device_time_total / 1e3:.3f} ms"
        for e in kernels[:4]))


def fma_chain_matches(r, s, rows=1024):
    """Whether the f32 r @ s the plain version takes (torch.einsum) equals,
    bit for bit on its first ``rows`` rows, one FMA chain over the factor
    columns in order (each step r_m s_m + b exact in f64, rounded once to
    f32), the order the f32 kernel's bias follows."""
    r = r[:, :, :rows]
    want = torch.einsum("bhqm,mk->bhqk", r, s)
    acc = torch.zeros_like(want)
    for i in range(s.shape[0]):
        acc = (r[..., i:i + 1].double() * s[i].double() + acc.double()
               ).float()
    return torch.equal(acc, want)


def lowrank_f64(q, k, v, r, s):
    """K3's function computed in float64 (the f32 kernel's and the plain
    version's own rounding errors are measured against it)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) / (
        q.shape[-1] ** 0.5)
    if r is not None:
        logits += torch.einsum("bhqm,mk->bhqk", r.double(), s.double())
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1),
                        v.double())


def phase_lowrank(lowrank, lowrank_reference):
    """K3 against its plain version at MViT's seven serving shapes and the
    JAX test's odd shapes, f32 and bf16, with and without the bias; then,
    at the serving shapes in bf16, times per call with CUDA events (plain,
    kernel, kernel, plain), beside scaled_dot_product_attention with r @ s
    materialized as its attn_mask in q's dtype (the mask made outside the
    timed call) and the bound; in f32 likewise at the training blocks 0-2,
    with SDPA's kernels named from a profile at block 0, and held to the
    same marks at LOWRANK_NARROW; a head dim of 160 and a bias of 129
    factor columns must be refused."""
    import torch.nn.functional as F
    from multi_modal_csi_tpu_torch.kernels.flash_attention_lowrank import \
        MAX_BIAS_RANK
    pytorch_defaults()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = {n: s for n, (s, _) in LOWRANK_SHAPES.items()}
    shapes.update(LOWRANK_ODD)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        for name, shape in (shapes | LOWRANK_NARROW if f32
                            else shapes).items():
            b, h, nq, nk, d, m = shape
            for bias in (False, True) if m else (False,):
                q, k, v = (torch.randn((b, h, n, d), generator=gen,
                                       device="cuda").to(dtype)
                           for n in (nq, nk, nk))
                r = s = None
                if bias:      # the class token's row and column carry 0
                    r = torch.randn((b, h, nq, m), generator=gen,
                                    device="cuda")
                    s = torch.randn((m, nk), generator=gen, device="cuda")
                    r[:, :, 0] = 0.0
                    s[:, 0] = 0.0
                out, lse = lowrank(q, k, v, r, s, return_lse=True)
                want, want_lse = lowrank_reference(q, k, v, r, s,
                                                   return_lse=True)
                torch.cuda.synchronize()
                err = (out.float() - want.float()).abs().max().item()
                top = want.float().abs().max().item()
                lse_rel = ((lse - want_lse).abs() / want_lse.abs()
                           .clamp_min(1e-30)).max().item()
                tol = (F32_TOL if dtype == torch.float32
                       else LOWRANK_BF16_SHARE * top)
                label = f"{name}{'+bias' if bias else ''}"
                print(f"K3 {label} {shape} {dtype}: max abs err {err:.3e} "
                      f"(tolerance {tol:.3e}, max |out| {top:.3f}), LSE max "
                      f"rel err {lse_rel:.2e} (tolerance {LOWRANK_LSE_RTOL})")
                if dtype == torch.float32 and name in LOWRANK_SHAPES:
                    exact = lowrank_f64(q, k, v, r, s)
                    print(f"K3 {label} f32 against the same function in "
                          f"f64: kernel {(out - exact).abs().max().item():.3e}"
                          f", plain {(want - exact).abs().max().item():.3e}")
                    del exact
                    if bias and name in LOWRANK_BWD_SHAPES:
                        # the f32 kernel's bias follows this order, and
                        # its err stays under F32_TOL because of it
                        chain = fma_chain_matches(r, s)
                        print(f"K3 {label}: r @ s of the plain version is one"
                              f" FMA chain over M (rows 0-1023): {chain}")
                        check(chain, f"K3 {label}: the plain version's r @ s"
                                     f" is not one FMA chain over M")
                check(out.dtype == dtype and out.shape == q.shape
                      and lse.shape == q.shape[:3],
                      f"K3 {label} {dtype} outputs {out.dtype} "
                      f"{tuple(out.shape)} {tuple(lse.shape)}")
                check(err <= tol, f"K3 {label} {dtype} err {err} > {tol}")
                check(lse_rel <= LOWRANK_LSE_RTOL,
                      f"K3 {label} {dtype} LSE rel err {lse_rel}")
                del out, lse, want, want_lse
                # timed: bf16 at the serving shapes, f32 at the training
                # blocks 0-2
                if name not in (LOWRANK_BWD_SHAPES if f32
                                else LOWRANK_SHAPES):
                    continue

                def timed(fn):
                    return cuda_ms(fn, reps=LOWRANK_REPS, warmup=1)

                plain = [timed(lambda: lowrank_reference(q, k, v, r, s))]
                kern = [timed(lambda: lowrank(q, k, v, r, s))]
                kern.append(timed(lambda: lowrank(q, k, v, r, s)))
                plain.append(timed(lambda: lowrank_reference(q, k, v, r, s)))
                mask = None if r is None else (r @ s).to(dtype)
                lib = timed(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask))
                if f32 and name == "block0":
                    sdpa_kernels(f"{label} f32", q, k, v, mask)
                del mask
                bytes_ms, ops_ms, tf32_ms = lowrank_bound(shape, bias, dtype)
                results[(label, dtype)] = dict(
                    err=err, ms=sum(kern) / 2, plain_ms=sum(plain) / 2,
                    library_ms=lib, bytes_ms=bytes_ms, ops_ms=ops_ms,
                    tf32_ms=tf32_ms)
                print(f"K3 {label} {dtype} per call: kernel {kern[0]:.3f}/"
                      f"{kern[1]:.3f} ms, plain {plain[0]:.3f}/{plain[1]:.3f}"
                      f" ms, sdpa {lib:.3f} ms; bound: bytes "
                      f"{1e3 * bytes_ms:.1f} us, operations "
                      f"{1e3 * ops_ms:.1f} us"
                      + (f" (3xTF32 {1e3 * tf32_ms:.1f} us)" if f32 else ""))
    for bias in (False, True):
        per_forward = {k: sum(n * results[(f"{name}{'+bias' if bias else ''}",
                                           torch.bfloat16)][k]
                              for name, (_, n) in LOWRANK_SHAPES.items())
                       for k in ("ms", "plain_ms", "library_ms", "bytes_ms",
                                 "ops_ms")}
        print(f"K3 per MViT-v{2 if bias else 1} bf16 forward at batch 2 "
              f"(16 calls): kernel {per_forward['ms']:.3f} ms, plain "
              f"{per_forward['plain_ms']:.3f} ms, sdpa "
              f"{per_forward['library_ms']:.3f} ms, bound "
              f"{max(per_forward['bytes_ms'], per_forward['ops_ms']):.3f} ms")
        per_step = {k: sum(results[(f"{name}{'+bias' if bias else ''}",
                                    torch.float32)][k]
                           for name in LOWRANK_BWD_SHAPES)
                    for k in ("ms", "plain_ms", "library_ms", "bytes_ms",
                              "ops_ms", "tf32_ms")}
        print(f"K3 per MViT-v{2 if bias else 1} f32 training step at batch 2 "
              f"(blocks 0-2, 3 calls): kernel {per_step['ms']:.3f} ms, plain "
              f"{per_step['plain_ms']:.3f} ms, sdpa "
              f"{per_step['library_ms']:.3f} ms, bound "
              f"{max(per_step['bytes_ms'], per_step['ops_ms']):.3f} ms at the "
              f"f32 peak, {max(per_step['bytes_ms'], per_step['tf32_ms']):.3f}"
              f" ms as 3xTF32")

    # a head dim above 128 or a bias past the kernels' factor columns, in
    # either dtype
    for dtype, d, m in ((torch.float32, 160, 0), (torch.bfloat16, 160, 0),
                        (torch.float32, 8, MAX_BIAS_RANK + 1),
                        (torch.bfloat16, 8, MAX_BIAS_RANK + 1)):
        q = torch.zeros((1, 1, 8, d), device="cuda", dtype=dtype)
        r = s = None
        if m:
            r = torch.zeros((1, 1, 8, m), device="cuda")
            s = torch.zeros((m, 8), device="cuda")
        try:
            lowrank(q, q, q, r, s)
            refused = False
        except ValueError as e:
            print(f"K3 {dtype} D={d} M={m}: refused ({e})")
            refused = True
        check(refused, f"K3 {dtype} launched at D={d}, M={m}")
    return results


def lowrank_bwd_bound(shape, bias, dtype, part):
    """The least times (ms) on an H100 SXM of K4's dQ/dR kernel ("dq"), its
    dK/dV/dS kernel ("dkv") or the whole backward ("both"): q, k, v, dO, r,
    s, the LSE and delta read once and the part's gradients written once
    over the HBM rate; its products over the peak of q's dtype (QK^T and
    dO V^T rebuilt, then dQ: 6 B*H*Nq*Nk*D for "dq"; dK and dV instead: 8;
    all five: 10) plus the f32 bias products (r s rebuilt, then dR: 4
    B*H*Nq*Nk*M; dS instead: 4; all three: 6) over the f32 peak. The third
    time is the operations bound in the tensor-core kernels' form: in f32
    every product as three TF32 products (3xTF32) over the TF32 peak, as
    the f32 kernels compute them all; in bf16 the head-dim products over
    the bf16 peak and the bias products as 3xTF32, as the bf16 dK/dV/dS
    kernel computes them (and K3's bf16 bound counts its bias)."""
    b, h, nq, nk, d, m = shape
    bh, m = b * h, m if bias else 0
    item = torch.tensor([], dtype=dtype).element_size()
    reads = (2 * bh * nq * d + 2 * bh * nk * d) * item + 4 * (
        bh * nq * m + m * nk + 2 * bh * nq)
    writes = {"dq": bh * nq * d * item + 4 * bh * nq * m,
              "dkv": 2 * bh * nk * d * item + 4 * m * nk}
    writes["both"] = writes["dq"] + writes["dkv"]
    at_dtype, in_f32 = {"dq": (6, 4), "dkv": (8, 4), "both": (10, 6)}[part]
    pairs = bh * nq * nk
    ops_ms = 1e3 * (at_dtype * pairs * d / PEAK_FLOPS[dtype]
                    + in_f32 * pairs * m / PEAK_FLOPS[torch.float32])
    tf32_ms = (1e3 * 3 * (at_dtype * d + in_f32 * m) * pairs / PEAK_TF32
               if dtype == torch.float32 else
               1e3 * (at_dtype * pairs * d / PEAK_FLOPS[dtype]
                      + 3 * in_f32 * pairs * m / PEAK_TF32))
    return 1e3 * (reads + writes[part]) / PEAK_BYTES, ops_ms, tf32_ms


def lowrank_bwd_f64(q, k, v, r, s, do):
    """K4's dQ, dK, dV, dR and dS (dR and dS None without a bias) computed
    in float64 from the same inputs, the softmax and delta included (the
    kernels' and the plain versions' own rounding errors are measured
    against it)."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / (q.shape[-1] ** 0.5)
    if r is not None:
        logits += torch.einsum("bhqm,mk->bhqk", r.double(), s.double())
    w = torch.softmax(logits, dim=-1)
    del logits
    delta = (do * torch.einsum("bhqk,bhkd->bhqd", w, v)).sum(dim=-1)
    dl = w * (torch.einsum("bhqd,bhkd->bhqk", do, v) - delta[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", w, do)
    del w
    dk = torch.einsum("bhqk,bhqd->bhkd", dl, q) / (q.shape[-1] ** 0.5)
    dq = torch.einsum("bhqk,bhkd->bhqd", dl, k) / (q.shape[-1] ** 0.5)
    ds = dr = None
    if r is not None:
        ds = torch.einsum("bhqm,bhqk->mk", r.double(), dl)
        dr = torch.einsum("bhqk,mk->bhqm", dl, s.double())
    return dq, dk, dv, dr, ds


def phase_lowrank_backward(lowrank, backward, backward_reference):
    """K4 against its plain version at MViT's three training block shapes
    and the odd shapes, f32 and bf16, with and without the bias, both fed
    the same out and LSE from K3: each gradient within LOWRANK_BWD_TOL of
    its largest magnitude. Then, at the training shapes in both dtypes
    (f32 the default train_dtype, bf16 the opt-in one), times per call of
    each kernel and of its plain part with CUDA events (plain, kernel,
    kernel, plain), beside the backward of scaled_dot_product_attention
    with r @ s as a mask of the dtype that takes a gradient (the mask made
    outside the timed call), and the bounds (f32: at the f32 peak and as
    3xTF32), summed per MViT-v1 and v2 training step; results keyed by
    (label, dtype). Both kernels of both dtypes must give the same bits
    twice at block 1 with the bias (fixed-order partials, rows written
    once, no atomics); at the training shapes the distance of each
    gradient of both kernels and of their plain versions from float64
    (``lowrank_bwd_f64``) is printed in both dtypes, and each bf16
    kernel's must be at most BF16_F64_RATIO times its plain version's; a
    head dim of 160 and a launch of either kernel at M = 130 must be
    refused in both dtypes."""
    import torch.nn.functional as F
    from multi_modal_csi_tpu_torch.kernels import flash_attention_lowrank
    from multi_modal_csi_tpu_torch.kernels.flash_attention_lowrank import \
        MAX_BIAS_RANK
    pytorch_defaults()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = dict(LOWRANK_BWD_SHAPES)
    shapes.update(LOWRANK_BWD_ODD)
    names = ("dq", "dk", "dv", "dr", "ds")
    results = {}
    for dtype, tol in LOWRANK_BWD_TOL.items():
        for name, shape in shapes.items():
            b, h, nq, nk, d, m = shape
            for bias in (False, True) if m else (False,):
                q, do = (torch.randn((b, h, nq, d), generator=gen,
                                     device="cuda").to(dtype)
                         for _ in range(2))
                k, v = (torch.randn((b, h, nk, d), generator=gen,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                r = s = None
                if bias:      # the class token's row and column carry 0
                    r = torch.randn((b, h, nq, m), generator=gen,
                                    device="cuda")
                    s = torch.randn((m, nk), generator=gen, device="cuda")
                    r[:, :, 0] = 0.0
                    s[:, 0] = 0.0
                out, lse = lowrank(q, k, v, r, s, return_lse=True)
                got = backward(q, k, v, r, s, out, lse, do)
                want = backward_reference(q, k, v, r, s, out, lse, do)
                torch.cuda.synchronize()
                label = f"{name}{'+bias' if bias else ''}"
                errs = {}
                for g_name, g, w in zip(names, got, want):
                    if w is None:
                        check(g is None, f"K4 {label} {g_name} without bias")
                        continue
                    check(g.dtype == w.dtype and g.shape == w.shape,
                          f"K4 {label} {dtype} {g_name} {g.dtype} "
                          f"{tuple(g.shape)}")
                    errs[g_name] = ((g.float() - w.float()).abs().max()
                                    .item(), w.float().abs().max().item())
                print(f"K4 {label} {shape} {dtype}: max abs err "
                      + ", ".join(f"{n} {e:.3e} (max |{n}| {t:.3f})"
                                  for n, (e, t) in errs.items())
                      + f"; tolerance {tol:.1e} of each max")
                for g_name, (err, top) in errs.items():
                    check(err <= tol * top, f"K4 {label} {dtype} {g_name} "
                                            f"err {err} > {tol} x {top}")
                # the tensor-core dK/dV/dS body's grid
                keys = flash_attention_lowrank.dkv_keys(
                    d, m if bias else 0, dtype)
                check(keys in (64, 128), f"K4 dkv {label} keys {keys}")
                splits = flash_attention_lowrank.dkv_splits(
                    b * h * -(-nk // keys), nq,
                    torch.cuda.get_device_properties(0).multi_processor_count)
                print(f"K4 dkv {label} {DTYPE_NAMES[dtype]} grid: {keys} keys"
                      f" a block, {splits} splits of the query range")
                if name not in LOWRANK_BWD_SHAPES:
                    del got, want
                    continue
                exact = lowrank_bwd_f64(q, k, v, r, s, do)

                def share(g, x):
                    return ((g.double() - x).abs().max()
                            / x.abs().max()).item()

                shares = {n: (share(g, x), share(w, x)) for n, g, w, x in
                          zip(names, got, want, exact) if x is not None}
                del exact
                for part, grads in (("dkv", ("dk", "dv", "ds")),
                                    ("dq", ("dq", "dr"))):
                    print(f"K4 {part} {label} {DTYPE_NAMES[dtype]} against "
                          f"the same function in f64, of each gradient's "
                          f"max: " + ", ".join(
                              f"{n} kernel {shares[n][0]:.3e} plain "
                              f"{shares[n][1]:.3e}" for n in grads
                              if n in shares))
                if dtype == torch.bfloat16:
                    for n in names:
                        if n in shares:
                            check(shares[n][0]
                                  <= BF16_F64_RATIO * shares[n][1],
                                  f"K4 {label} bf16 {n}: "
                                  f"{shares[n][0]} from float64, over "
                                  f"{BF16_F64_RATIO} x the plain version's "
                                  f"{shares[n][1]}")
                del got, want

                def timed(fn):
                    return cuda_ms(fn, reps=LOWRANK_REPS, warmup=1)

                delta = (do.float() * out.float()).sum(dim=-1)
                args = (q, k, v, r, s, do, lse, delta)
                row = {}
                for part, grads in (("dq", ("dq", "dr")),
                                    ("dkv", ("dk", "dv", "ds"))):
                    kernel = getattr(flash_attention_lowrank,
                                     f"lowrank_backward_{part}")
                    plain_fn = getattr(flash_attention_lowrank,
                                       f"lowrank_backward_{part}_reference")
                    plain = [timed(lambda: plain_fn(*args))]
                    kern = [timed(lambda: kernel(*args)) for _ in range(2)]
                    plain.append(timed(lambda: plain_fn(*args)))
                    bytes_ms, ops_ms, tf32_ms = lowrank_bwd_bound(
                        shape, bias, dtype, part)
                    row[part] = dict(
                        err=max(errs[g][0] for g in grads if g in errs),
                        ms=sum(kern) / 2, plain_ms=sum(plain) / 2,
                        bytes_ms=bytes_ms, ops_ms=ops_ms, tf32_ms=tf32_ms)
                    print(f"K4 {part} {label} {dtype} per call: kernel "
                          f"{kern[0]:.3f}/{kern[1]:.3f} ms, plain "
                          f"{plain[0]:.3f}/{plain[1]:.3f} ms; bound: bytes "
                          f"{1e3 * bytes_ms:.1f} us, operations "
                          f"{1e3 * ops_ms:.1f} us ("
                          + ("3xTF32" if dtype == torch.float32 else
                             "the bias as 3xTF32")
                          + f" {1e3 * tf32_ms:.1f} us)")
                if bias and name == "block1":
                    # the same bits twice: fixed-order partials (dK/dV/dS)
                    # and rows written once (dQ/dR), no atomics
                    for part in ("dkv", "dq"):
                        kernel = getattr(flash_attention_lowrank,
                                         f"lowrank_backward_{part}")
                        first, again = kernel(*args), kernel(*args)
                        same = all(torch.equal(a, b)
                                   for a, b in zip(first, again))
                        print(f"K4 {part} {label} {DTYPE_NAMES[dtype]} "
                              f"twice: bit for bit {same}")
                        check(same, f"K4 {part} {label} {dtype} differs run "
                                    f"to run")
                        del first, again
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                if bias:
                    leaves.append((r @ s).to(dtype).requires_grad_())
                lib_out = F.scaled_dot_product_attention(
                    *leaves[:3], attn_mask=leaves[3] if bias else None)
                row["library_ms"] = timed(lambda: torch.autograd.grad(
                    lib_out, leaves, do, retain_graph=True))
                del leaves, lib_out
                row["bytes_ms"], row["ops_ms"], _ = lowrank_bwd_bound(
                    shape, bias, dtype, "both")
                results[(label, dtype)] = row
                print(f"K4 {label} {dtype} per backward: kernels "
                      f"{row['dq']['ms'] + row['dkv']['ms']:.3f} ms, plain "
                      f"{row['dq']['plain_ms'] + row['dkv']['plain_ms']:.3f}"
                      f" ms, sdpa backward {row['library_ms']:.3f} ms; "
                      f"bound {max(row['bytes_ms'], row['ops_ms']):.3f} ms")
    for dtype, bias in ((d, b) for d in LOWRANK_BWD_TOL
                        for b in (False, True)):
        rows = [results[(f"{name}{'+bias' if bias else ''}", dtype)]
                for name in LOWRANK_BWD_SHAPES]
        step = f"MViT-v{2 if bias else 1} {DTYPE_NAMES[dtype]}"

        def total(part, field):
            return sum(r[part][field] for r in rows)

        print(f"K4 per {step} training step at batch "
              f"2 ({K4_PER_STEP} backwards): kernels "
              f"{total('dq', 'ms') + total('dkv', 'ms'):.3f} ms (dq "
              f"{total('dq', 'ms'):.3f}, dkv {total('dkv', 'ms'):.3f}), "
              f"plain {total('dq', 'plain_ms') + total('dkv', 'plain_ms'):.3f}"
              f" ms, sdpa backward "
              f"{sum(r['library_ms'] for r in rows):.3f} ms, bound "
              f"{sum(max(r['bytes_ms'], r['ops_ms']) for r in rows):.3f} ms")
        for part in ("dq", "dkv"):
            bytes_ms = total(part, "bytes_ms")
            print(f"K4 {part} per {step} training "
                  f"step: kernel {total(part, 'ms'):.3f} ms, plain "
                  f"{total(part, 'plain_ms'):.3f} ms, bound "
                  f"{max(bytes_ms, total(part, 'ops_ms')):.3f} ms at the "
                  f"{DTYPE_NAMES[dtype]} peak"
                  + (" (the bias at the f32 peak)"
                     if dtype == torch.bfloat16 else "")
                  + f", {max(bytes_ms, total(part, 'tf32_ms')):.3f} ms as "
                  + ("3xTF32" if dtype == torch.float32 else
                     "the kernel forms it (the bias as 3xTF32)"))

    w = torch.zeros((1, 1, 8), device="cuda")
    for dtype in LOWRANK_BWD_TOL:
        z = torch.zeros((1, 1, 8, 160), device="cuda", dtype=dtype)
        try:
            backward(z, z, z, None, None, z, w, z)
            refused = False
        except ValueError as e:
            print(f"K4 {DTYPE_NAMES[dtype]} D=160: refused ({e})")
            refused = True
        check(refused, f"K4 {dtype} launched with a head dim above 128")
    m = MAX_BIAS_RANK + 2
    r, s = torch.zeros((1, 1, 8, m), device="cuda"), torch.zeros(
        (m, 8), device="cuda")
    for dtype in LOWRANK_BWD_TOL:
        z = torch.zeros((1, 1, 8, 8), device="cuda", dtype=dtype)
        try:
            flash_attention_lowrank.lowrank_backward_dkv(z, z, z, r, s, z, w,
                                                         w)
            refused = False
        except ValueError as e:
            print(f"K4 dkv {DTYPE_NAMES[dtype]} M={m}: refused ({e})")
            refused = True
        check(refused, f"K4's {dtype} dK/dV/dS launched at M={m}")
        try:
            flash_attention_lowrank.lowrank_backward_dq(z, z, z, r, s, z, w,
                                                        w)
            refused = False
        except ValueError as e:
            print(f"K4 dq {DTYPE_NAMES[dtype]} M={m}: refused ({e})")
            refused = True
        check(refused, f"K4's {dtype} dQ/dR launched at M={m}")
    return results


def video_requests():
    rng = np.random.default_rng(SEED)
    return [rng.standard_normal((n, *VIDEO_CLIP, 3), dtype=np.float32)
            for n in VIDEO_REQUESTS]


def video_serve_phase(key, requests):
    """Serve ``requests`` (host arrays of (n, 45, 224, 224, 3) clips) with
    ``key`` in bf16 at batch 2: exactly 16 K3 launches per batch forward,
    clips/s from host memory and resident, a profile; then a training
    forward and backward of one batch, exactly 3 K3 and 3 of each K4
    kernel. Returns the serving and the training launch counts."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.serving import VideoServer
    from multi_modal_csi_tpu_torch.runners.video import build_video_model

    pytorch_defaults()
    server = VideoServer(key, build_video_model(key, VIDEO_OUT, VIDEO_CLIP,
                                                seed=SEED),
                         dtype="bfloat16", device="cuda")
    check(server.batch == 2 and server.dtype == torch.bfloat16,
          f"{key} serves at batch {server.batch} in {server.dtype}")
    server(requests[0])                                       # warm-up
    torch.cuda.synchronize()
    batch = torch.from_numpy(requests[0][:server.batch]).cuda()
    kernels.reset_launch_counts()
    server.forward(batch)
    torch.cuda.synchronize()
    one = dict(kernels.LAUNCH_COUNTS)
    print(f"{key}: launches in one batch forward: {one}")
    check(one == {"flash_attention_lowrank_bias": K3_PER_FORWARD},
          f"{key} launched {one} in one forward, expected "
          f"{K3_PER_FORWARD} K3")

    # the main path: ragged requests from host memory to logits on the host
    kernels.reset_launch_counts()
    start = time.perf_counter()
    outs = [server(r).cpu() for r in requests]
    host_s = time.perf_counter() - start
    launches = dict(kernels.LAUNCH_COUNTS)
    batches = sum(-(-len(r) // server.batch) for r in requests)
    n = sum(len(r) for r in requests)
    for r, out in zip(requests, outs):
        print(f"{key}: request of {len(r)} clips -> {tuple(out.shape)}")
        check(tuple(out.shape) == (len(r), VIDEO_OUT)
              and out.dtype == torch.float32
              and bool(torch.isfinite(out).all()),
              f"{key} output {tuple(out.shape)} {out.dtype} not finite f32")
    print(f"{key}: main path ran {batches} batch forwards, launches "
          f"{launches}")
    check(launches == {"flash_attention_lowrank_bias":
                       K3_PER_FORWARD * batches},
          f"{key} launched {launches}, expected "
          f"{K3_PER_FORWARD * batches} K3")

    resident = [torch.from_numpy(r).cuda() for r in requests]
    rates = []
    for _ in range(RESIDENT_ROUNDS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for r in resident:
            server(r)
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - start))
    del resident
    SERVE_RATES[key] = (n / host_s, rates)
    print(f"{key} bf16 batch {server.batch}: {n / host_s:.2f} clips/s from "
          f"host memory, {n} clips in {batches} batch forwards; with the "
          f"clips already on the card, {RESIDENT_ROUNDS} timings: "
          + ", ".join(f"{r:.2f}" for r in rates) + " clips/s")
    attention_share(key, "K3", profile_device(
        key, lambda: server.forward(batch), PROFILED_FORWARDS, "forward"))

    # a training forward and backward of the same bf16 model: K3 and K4 at
    # blocks 0-2 (the training gate), the eager path at blocks 3-15
    model = server.model.train()
    kernels.reset_launch_counts()
    try:
        model(batch.to(server.dtype)).float().sum().backward()
        torch.cuda.synchronize()
    finally:
        model.zero_grad(set_to_none=True)
        model.eval()
    step = dict(kernels.LAUNCH_COUNTS)
    print(f"{key} bf16 training forward and backward: launches {step}")
    check(step == {K3: K4_PER_STEP, DQ: K4_PER_STEP, DKV: K4_PER_STEP},
          f"{key} training step launched {step}")
    return launches, step


def video_card_vs_cpu(key):
    """The same seeded weights in f32 (default flags) at (2, 16, 112, 112, 3)
    on the card and on the CPU, where K3's plain version runs: logits
    within VIDEO_F32_SHARE of the largest."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.serving import VideoServer
    from multi_modal_csi_tpu_torch.runners.video import build_video_model
    pytorch_defaults()
    x = np.random.default_rng(SEED + 1).standard_normal(
        (2, *VIDEO_CPU_CLIP, 3), dtype=np.float32)
    got = {}
    for device in ("cuda", "cpu"):
        model = build_video_model(key, VIDEO_OUT, VIDEO_CPU_CLIP, seed=SEED)
        kernels.reset_launch_counts()
        got[device] = VideoServer(key, model, dtype="float32",
                                  device=device)(x).cpu().numpy()
        if device == "cuda":
            launches = dict(kernels.LAUNCH_COUNTS)
    err = float(np.abs(got["cuda"] - got["cpu"]).max())
    top = float(np.abs(got["cpu"]).max())
    print(f"{key} f32 card vs CPU at {VIDEO_CPU_CLIP}: max abs err "
          f"{err:.3e} (tolerance {VIDEO_F32_SHARE} x {top:.4f}); card "
          f"launches {launches}")
    check(err <= VIDEO_F32_SHARE * top, f"{key} card vs CPU err {err}")
    check(launches == {"flash_attention_lowrank_bias": VIDEO_CPU_K3},
          f"{key} card launched {launches}, expected {VIDEO_CPU_K3} K3")
    return launches


def video_evaluate_phase(work, key):
    """runners/video.py::evaluate over a ClipDataset of EVAL_CLIPS seeded
    (45, 224, 224, 3) .npy clips, bf16, chunks of 2, the model loaded with
    load_video_pretrained from a torchvision-layout .pt written here at
    torchvision's (16, 224, 224) clip: the logits against VideoServer's on
    the same clips, the predictions and accuracy against the logits."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.serving import VideoServer
    from multi_modal_csi_tpu_torch.data.video_io import (ClipDataset,
                                                         load_clips)
    from multi_modal_csi_tpu_torch.metrics.classification import \
        accuracy_score
    from multi_modal_csi_tpu_torch.runners.video import (
        build_video_model, evaluate, load_video_pretrained)
    from multi_modal_csi_tpu_torch.train.loop import cast_for_serving
    pytorch_defaults()
    rng = np.random.default_rng(SEED + 2)
    root = os.path.join(work, "clips")
    os.makedirs(root, exist_ok=True)
    labels = [f"act_{i}" for i in range(EVAL_CLIPS)]
    for label in labels:
        np.save(os.path.join(root, f"{label}.npy"), rng.standard_normal(
            (*VIDEO_CLIP, 3), dtype=np.float32))
    y = rng.integers(0, 2, (EVAL_CLIPS, VIDEO_OUT)).astype(np.float32)
    path = os.path.join(work, f"{key}.pt")
    torch.save(build_video_model(key, 400, PRETRAINED_CLIP, seed=SEED + 3)
               .backbone.state_dict(), path)
    model = load_video_pretrained(path, key, build_video_model(
        key, VIDEO_OUT, VIDEO_CLIP, seed=SEED))
    model = cast_for_serving(model.cuda(), torch.bfloat16)
    kernels.reset_launch_counts()
    start = time.perf_counter()
    acc, pred, logits = evaluate(model, ClipDataset(root, labels, y), 0.5,
                                 chunk=2, dtype=torch.bfloat16)
    wall = time.perf_counter() - start
    launches = dict(kernels.LAUNCH_COUNTS)
    chunks = -(-EVAL_CLIPS // 2)
    served = VideoServer(key, model, dtype="bfloat16", device="cuda")(
        load_clips(root, labels)).cpu().numpy()
    err = float(np.abs(logits - served).max())
    print(f"{key} evaluate over {EVAL_CLIPS} cached clips from a "
          f"{PRETRAINED_CLIP} checkpoint: {wall:.3f} s, accuracy {acc:.3f},"
          f" logits vs VideoServer max abs err {err:.3e}; launches "
          f"{launches}")
    check(logits.shape == (EVAL_CLIPS, VIDEO_OUT)
          and np.isfinite(logits).all(), f"{key} evaluate logits")
    check(err <= 1e-3 * np.abs(served).max(),
          f"{key} evaluate vs VideoServer err {err}")
    check(np.array_equal(pred, (1 / (1 + np.exp(-logits)) > 0.5)
                         .astype(int))
          and acc == accuracy_score(y.astype(int), pred),
          f"{key} evaluate predictions or accuracy")
    check(launches == {"flash_attention_lowrank_bias":
                       K3_PER_FORWARD * chunks},
          f"{key} evaluate launched {launches}")
    return launches


def video_train_phase(key, dtype=torch.float32):
    """One MViT training step at full width on the card, in ``dtype``: f32
    (the default train_dtype; PyTorch's default TF32 settings) or bf16 (as
    fit_video trains with train_dtype="bfloat16": the parameters and
    Adam's moments in bf16, each batch cast), batch 2, seeded
    (45, 224, 224, 3) clips on the card: exactly 3 K3 and 3 of each K4
    kernel; the peak memory of a step; clips trained per second; 5 steps
    under torch.profiler, with K3's and K4's shares of the device time;
    then whether one step at the JAX CLI's batch 8 fits in the card's
    memory. Returns the counted step's launches."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
    from multi_modal_csi_tpu_torch.runners.video import build_video_model
    from multi_modal_csi_tpu_torch.train.loop import (TRAIN_DTYPES,
                                                      adam_like_torch,
                                                      cast_parameters,
                                                      make_train_step)
    pytorch_defaults()
    rng = np.random.default_rng(SEED + 4)

    def batch(n):
        x = rng.standard_normal((n, *VIDEO_CLIP, 3), dtype=np.float32)
        y = (rng.random((n, VIDEO_OUT)) < 0.5).astype(np.float32)
        return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()

    name = DTYPE_NAMES[dtype]
    batch_dtype = TRAIN_DTYPES[dtype]
    model = build_video_model(key, VIDEO_OUT, VIDEO_CLIP, seed=SEED).cuda()
    cast_parameters(model, batch_dtype)
    step = make_train_step(model, adam_like_torch(model.parameters(), 1e-4),
                           bce_with_logits, augment=False,
                           batch_dtype=batch_dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bx, by = batch(VIDEO_TRAIN_BATCH)
    step(bx, by, gen)                                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step(bx, by, gen)
    torch.cuda.synchronize()
    one = dict(kernels.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{key} {name} training step at batch {VIDEO_TRAIN_BATCH}: "
          f"launches {one}; peak memory {peak:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}")
    check(one == {K3: K4_PER_STEP, DQ: K4_PER_STEP, DKV: K4_PER_STEP},
          f"{key} {name} training step launched {one}")
    train_rate(f"{key} {name} training", step, bx, by, gen, unit="clips")
    profile = profile_device(f"{key} {name} training",
                             lambda: step(bx, by, gen), PROFILED_STEPS,
                             "step")
    for what, marks in (("K3", ("tc::attention_kernel",
                                "tc::attention_f32_kernel")),
                        ("K4 dQ/dR", ("tc::attention_bwd_dq_lowrank",)),
                        ("K4 dK/dV/dS", ("tc::attention_bwd_dkv",))):
        ms = sum(t for kernel, t in profile["kernels"].items()
                 if any(mark in kernel for mark in marks))
        print(f"{key} {name} training: {what} {ms:.3f} ms per step, "
              f"{100 * ms / profile['device_ms']:.1f}% of the device time")
    del bx, by
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        step(*batch(VIDEO_CLI_BATCH), gen)
        torch.cuda.synchronize()
        print(f"{key} {name} training step at batch {VIDEO_CLI_BATCH}: fits,"
              f" peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    except torch.cuda.OutOfMemoryError:
        print(f"{key} {name} training step at batch {VIDEO_CLI_BATCH}: does "
              f"not fit in the card's memory")
    del model, step
    torch.cuda.empty_cache()
    return one


def video_train_card_vs_cpu():
    """One f32 MViT-v2 training step at (1, 32, 224, 224, 3) on the card
    (default flags; K3 and K4 at blocks 0-2, 50177, 12545 and 12545 queries)
    and on the CPU (the eager attention everywhere), from the same seeded
    weights and clip, dropout and drop-path off: the loss within
    STEP_F32_TOL relative and each gradient within GRAD_F32_TOL of its
    tensor's scale, as train_step_card_vs_cpu holds THAT's.

    The residual path's max pooling (``_pool_skip``) picks the largest of
    a window; where two candidates lie within rounding of each other the
    devices can pick different ones and route the gradient elsewhere. So
    the CPU step takes the card's picks (``KinkReplay``), and the
    comparison measures rounding alone."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
    from multi_modal_csi_tpu_torch.runners.video import build_video_model
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      make_train_step)
    pytorch_defaults()
    rng = np.random.default_rng(SEED + 5)
    x = rng.standard_normal((1, *VIDEO_STEP_CLIP, 3), dtype=np.float32)
    y = (rng.random((1, VIDEO_OUT)) < 0.5).astype(np.float32)
    picks = KinkReplay("MViT-v2")
    got = {}
    for device in ("cuda", "cpu"):
        with picks.on(device):
            model = without_dropout(build_video_model(
                "MViT-v2", VIDEO_OUT, VIDEO_STEP_CLIP, seed=SEED)).to(device)
            step = make_train_step(model, adam_like_torch(
                model.parameters(), 1e-4), bce_with_logits, augment=False)
            kernels.reset_launch_counts()
            start = time.perf_counter()
            loss, _ = step(torch.from_numpy(x).to(device),
                           torch.from_numpy(y).to(device),
                           torch.Generator(device=device).manual_seed(SEED))
        got[device] = (float(loss), {n: p.grad.detach().cpu() for n, p
                                     in model.named_parameters()})
        print(f"MViT-v2 f32 training step at {VIDEO_STEP_CLIP} on "
              f"{device}: {time.perf_counter() - start:.2f} s, launches "
              f"{dict(kernels.LAUNCH_COUNTS)}")
        if device == "cuda":
            launches = dict(kernels.LAUNCH_COUNTS)
        del model, step
    check(launches == {K3: K4_PER_STEP, DQ: K4_PER_STEP, DKV: K4_PER_STEP},
          f"card step launched {launches}")
    (card_loss, card), (cpu_loss, cpu) = got["cuda"], got["cpu"]
    floor = 1e-2 * max(g.abs().max().item() for g in cpu.values())
    worst = max((((card[n] - cpu[n]).abs().max().item()
                  / max(cpu[n].abs().max().item(), floor)), n) for n in cpu)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"MViT-v2 f32 training step, card vs CPU: {picks.report()}; "
          f"loss {card_loss:.6f} vs {cpu_loss:.6f} "
          f"(relative {rel:.2e}, tolerance {STEP_F32_TOL}); worst gradient "
          f"{worst[0]:.2e} of its scale in {worst[1]} (tolerance "
          f"{GRAD_F32_TOL})")
    check(rel <= STEP_F32_TOL, f"card vs CPU MViT step loss relative {rel}")
    check(worst[0] <= GRAD_F32_TOL, f"card vs CPU MViT gradient {worst}")
    return launches


def write_video_run(root):
    """annotation.csv of RUN_CLIPS empty-room clips (seeded users, absent
    users' cells empty) and their seeded (45, 224, 224, 3) f32 .npy clips.
    Returns the clip directory and the annotation's path."""
    rng = np.random.default_rng(SEED + 6)
    clips = os.path.join(root, "video_cache")
    os.makedirs(clips, exist_ok=True)
    header = ["label", "environment", "wifi_band", "number_of_users"] + [
        f"user_{u}_{what}" for u in range(1, 7)
        for what in ("location", "activity")]
    annotation = os.path.join(root, "video_annotation.csv")
    with open(annotation, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        for i in range(RUN_CLIPS):
            users = int(rng.integers(0, 6))
            row = [f"clip_{i}", "empty_room", "5", str(users)]
            for u in range(6):
                row += ["a", "walk"] if u < users else ["", ""]
            writer.writerow(row)
            np.save(os.path.join(clips, f"clip_{i}.npy"), rng.standard_normal(
                (*VIDEO_CLIP, 3), dtype=np.float32))
    return clips, annotation


def run_video_phase(clips, annotation, work, key, train_dtype="float32",
                    save_model=None):
    """The video experiment path (cli/run_video.py -> run_video_model ->
    fit_video) on the card: RUN_CLIPS cached clips, identity task, repeat
    1, one epoch at batch 2, the final test pass in the serving dtype
    (bf16); the result JSON read back with the JAX runner's keys and
    exactly 3 K3 and 3 of each K4 kernel per step and 16 K3 per
    evaluation chunk. With ``save_model`` (path.save_model, absent before
    the run, so the run starts from fresh weights) the saved file must hold
    the best weights that fit_video returned, bit for bit, and load
    strictly into a fresh model of ``key``. Returns the launch counts and
    how many of the K3 launches ran in f32 (all but the final test pass's,
    when training in f32)."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.cli import run_video
    from multi_modal_csi_tpu_torch.data.splits import train_test_split
    pytorch_defaults()
    rows = np.arange(RUN_CLIPS)
    n_train, n_test = (len(a) for a in
                       train_test_split(rows, rows, 0.2, 39)[:2])
    steps = n_train // VIDEO_TRAIN_BATCH
    # per epoch the training and test sets, then the final test pass
    chunks = (-(-n_train // VIDEO_TRAIN_BATCH)
              + 2 * -(-n_test // VIDEO_TRAIN_BATCH))
    from multi_modal_csi_tpu_torch.runners import video as video_runner
    save = os.path.join(work, "results", f"{key}-{train_dtype}.json")
    args = [
        "--model", key, "--repeat", "1",
        "--set", f"path.video_pre_x={clips}",
        "--set", f"path.data_y={annotation}", "--set", f"path.save={save}",
        "--set", "nn.epoch=1", "--set", f"nn.batch_size={VIDEO_TRAIN_BATCH}",
        "--set", f"train_dtype={train_dtype}",
        "--set", "compute_dtype=auto"]
    best = []
    real_fit = video_runner.fit_video
    if save_model:
        check(not os.path.exists(save_model), f"{save_model} exists")
        args += ["--set", f"path.save_model={save_model}"]

        def recording(*a, **k):
            out = real_fit(*a, **k)
            best.append(out[0])
            return out

        video_runner.fit_video = recording
    kernels.reset_launch_counts()
    start = time.perf_counter()
    try:
        result = run_video.main(args)
    finally:
        video_runner.fit_video = real_fit
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = dict(kernels.LAUNCH_COUNTS)
    if save_model:
        saved = torch.load(save_model, map_location="cpu", weights_only=True)
        check(len(best) == 1 and set(saved) == set(best[0]) and all(
            torch.equal(saved[k], v.float()) for k, v in best[0].items()),
            f"{key}: path.save_model does not hold the run's best weights")
        video_runner.build_video_model(key, VIDEO_OUT).load_state_dict(
            saved, strict=True)
        print(f"{key} run_video saved its best weights to path.save_model: "
              f"{len(saved)} entries, "
              f"{os.path.getsize(save_model) / 2 ** 20:.1f} MiB, equal to "
              f"fit_video's bit for bit, loaded strictly into a fresh "
              f"{key}")
    with open(save) as f:
        written = json.load(f)
    fit_s = result["time_train"]["avg"]
    rate = steps * VIDEO_TRAIN_BATCH / fit_s
    print(f"{key} run_video ({train_dtype}): {n_train} training and {n_test}"
          f" test clips; {wall:.2f} s wall, fit {fit_s:.2f} s ({steps} steps "
          f"and the evaluation of both sets: {rate:.2f} clips trained/s "
          f"over fit's wall time), final bf16 test pass "
          f"{result['time_test']['avg']:.3f} s; accuracy "
          f"{result['accuracy']['avg']:.3f}, parameters "
          f"{result['complexity']['parameter']}, forward FLOPs (CPU) "
          f"{result['complexity']['flops']:.4g}; launches {launches}")
    check(set(written) == VIDEO_RESULT_KEYS,
          f"{key} result JSON keys {sorted(written)}")
    check(written["model"] == key and "micro avg" in written["repeat_0"]
          and all(math.isfinite(written[k]["avg"]) for k in
                  ("accuracy", "time_train", "time_test")),
          f"{key} result JSON values")
    want = {K3: K4_PER_STEP * steps + K3_PER_FORWARD * chunks,
            DQ: K4_PER_STEP * steps, DKV: K4_PER_STEP * steps}
    check(launches == want, f"{key} run launched {launches}, expected "
                            f"{want}")
    final_pass = K3_PER_FORWARD * -(-n_test // VIDEO_TRAIN_BATCH)
    return launches, (launches[K3] - final_pass
                      if train_dtype == "float32" else 0)


# ---------------------------------------------------------------------- #
# P1: the products of int8 serving (kernels/int8_matmul.py)
# ---------------------------------------------------------------------- #

S8, BF16 = "int8_matmul_s8", "int8_matmul_bf16"
COLUMNS = "int8_quantize_columns"
COLUMNS3D = "int8_quantize_columns3d"
CONV3D = "int8_conv3d"
P1_TILE = (256, 272, 424)            # tools/exp_pallas_int8.py:36
# (M, K, N) of each product in one bs256 forward at full width, and its
# launches: the w8a8 layers (int8) and the weight-only attention
# projections (bf16), as the models are built (4 encoder blocks, 6 uses of
# the shared decoder layer whose memory K and V are projected once)
DETR_S8 = {(768000, 270, 270): 1,    # initial_conv.pointwise, 1x1
           (256000, 810, 270): 4,    # dilated_blocks.{0..3}.conv, k3
           (2560, 27000, 270): 1,    # final_conv, k = stride = 100
           (2560, 270, 270): 4,      # encoder layer_cnn.0, k1, 4 blocks
           (1280, 270, 512): 6,      # decoder ffn.0
           (1280, 512, 270): 6}      # decoder ffn.3
DETR_BF16 = {(2560, 270, 270): 4 * 4 + 2,    # encoder q, k, v, out; memory
             (1280, 270, 270): 6 * 4 + 6 * 2}  # k, v; decoder self q, k,
                                               # v, out and cross q, out
ENCODER_S8 = {(38400, 270, 270): 4,  # left blocks: convs k1, k3, k5
              (38400, 810, 270): 4,
              (38400, 1350, 270): 4,
              (69120, 270, 270): 1,  # right block: convs k1, k2, k3
              (69120, 540, 270): 1,
              (69120, 810, 270): 1,
              (1280, 270, 2048): 6,  # decoder ffn.0 and ffn.3
              (1280, 2048, 270): 6}
ENCODER_BF16 = {(38400, 270, 270): 4 * 4,    # left blocks q, k, v, out
                (69120, 270, 270): 4,        # right block
                (107520, 270, 270): 2,       # the 420-token memory's k, v
                (1280, 270, 270): 6 * 4 + 6 * 2}
# prologue launches in one bs256 forward: one for each s8 product (its
# input quantized) and one for each bf16 product whose input arrives in f32
# (cast to bf16 at the padded stride: the attention projections after the
# f32 LayerNorms); a bf16 input whose rows 4-byte copies divide is read as
# it is
DETR_COLUMNS = 22 + 30
ENCODER_COLUMNS = 27 + 26
# (G, M, K, N): odd sizes, a K with K mod 32 = 14, a grouped product
P1_ODD = [(None, 1, 1, 1), (None, 17, 33, 65), (None, 300, 810, 270),
          (None, 100, 46, 70), (3, 100, 90, 30)]
# the implicit conv at odd shapes, (x (B, T, H, W, C), N, kernel, stride,
# pads): split-K (one row tile, K of 1,728 bytes), C = 24 (codes of 32
# int8, 24 bf16), two column tiles at S3D's stride-2 (7, 1, 1), a 2-D conv,
# a 16-byte K, and long K (128-byte stages) over three column tiles
CONV3D_ODD = [((1, 3, 4, 5, 64), 40, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
              ((2, 5, 9, 7, 24), 16, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
              ((2, 9, 3, 5, 64), 100, (7, 1, 1), (2, 1, 1), (3, 0, 0)),
              ((2, 1, 23, 19, 32), 16, (1, 7, 7), (1, 3, 3), (0, 0, 0)),
              ((3, 4, 6, 5, 16), 24, (1, 1, 1), (2, 2, 2), (0, 0, 0)),
              ((2, 6, 10, 12, 128), 200, (3, 3, 3), (1, 2, 2),
               (1, 1, 1))]
# MViT-v2 w8 (bf16 serving, batch 2): its Linears of at least 16384
# weights, each called once a forward: qkv 16, attn.project.0 15 (block 0's
# 96 x 96 stays float), mlp.0 and mlp.3 32, the widening block projects 3,
# head.1 1 (the 400 x 6 task head stays float)
MVIT_BF16_PER_FORWARD = 16 + 15 + 32 + 3 + 1
# every one of them takes its bf16 activation as it is: no prologue
# bf16 x bf16 -> f32 against the exact product (f64 of the bf16 values):
# each element within K * 2^-23 * sum |a b|, the bound of K f32 additions
# in any order, each rounding by at most one unit of 2^-23 relative (so
# truncating accumulation is covered too)
P1_BF16_BOUND = 2.0 ** -23
# Beyond LONG_K that any-order bound is looser than the product itself (at
# MLP w8's layer_0, K = 810,000, it is 0.1 sum |a b| an element, while the
# elements are about 2e-3 of sum |a b|: an all-zero output would pass).
# There an element is held to LONG_K_LAMBDA 2^-24 sqrt(K) sum |a b|, the
# probabilistic bound of K f32 additions (Higham and Mary, 2019) with its
# lambda set from readings (probes/p1_long_k_tolerance.py on an H100 SXM):
# the kernel reads 1.76e-3 of 2^-24 sqrt(K) sum |a b| at layer_0, so
# lambda = 2^-4 leaves it a margin of about 35, while the output without
# one of its 44 splits of K, or without one 64-value stage, reads far
# beyond the bound (p1_w8_case checks that on every run)
LONG_K = 2 ** 16
LONG_K_LAMBDA = 2.0 ** -4
STAGE_VALUES = 64          # bf16 values in one 128-byte long-K stage of A
# card vs CPU logits of the same int8 weights and scales at f32 serving,
# of the largest logit: activations that the two devices' f32 arithmetic
# put on either side of an int8 rounding boundary take the other value
# (one step at the first quantized layer) and the flips compound over the
# quantized layers (the CPU tests measure 8.8e-3 between JAX and the port
# for DETR)
INT8_CPU_SHARE = 2e-2
# a layer's int8 codes on the CPU fed the card's codes of every layer
# before it: the share that may differ from the card's. Each layer's
# input then differs between the devices by one layer's f32 rounding
# (the epilogue's, the BatchNorm's, an f32 conv's), a few ulps, which puts
# about 1e-5 to 1e-4 of the codes on the other side of a rounding
# boundary; a wrong scale or rounding rule moves a share of order 0.1
INT8_FLIP_SHARE = 1e-3
# w8a8 / w8 logits against bf16 serving, over the bf16 logits' spread: the
# JAX package's own bounds against float (tests/test_quantize.py:171, :208,
# :300)
INT8_SPREAD_BOUND = {"DETR": 0.35, "THAT_ENCODER": 0.5, "MViT-v2": 0.35,
                     "MLP": 0.25, "ResNet": 0.35}
# MLP in w8 (its QUANT_DEFAULTS), bf16, batch 256: layer_0 reads the input
# BatchNorm's bf16 output and layer_1 the ReLU's as they are (no prologue);
# the 54-wide head (6,912 weights) stays float
MLP_BF16 = {(256, 810000, 256): 1, (256, 256, 128): 1}
MLP_W8_SHAPE = (256, 810000, 256)     # (M, K, N) of layer_0
# CNN-1D in w8a8, bf16, batch 256: the three convs' columns (k29 s13 over
# 3000 steps of 270 channels: 229 rows a window; k15 s7: 31; k3: 29) and
# the head on the time mean, each after its prologue
CNN1D_S8 = {(256 * 229, 29 * 270, 128): 1, (256 * 31, 15 * 128, 256): 1,
            (256 * 29, 3 * 256, 512): 1, (256, 512, 54): 1}
CNN1D_COLUMNS = 4
# the six WiMANS baselines, served and trained at full width; their
# serving rates on the card, training rates and profiles (bf16 and int8
# serving, f32 training) are not timed: that depth pays for
# launcher_phase (PERF.md keeps their last figures), every check kept
BASELINES = ("MLP", "CNN-1D", "CNN-2D", "LSTM", "CLSTM", "ABLSTM")
# bf16 serving of these runs the LSTM step loop (4,800 and 12,000 launch
# calls a forward, host-paced): served one request (one batch forward)
# each, at full width, to keep the phase's time
STEP_LOOPS = ("LSTM", "ABLSTM")
CALIB_WINDOWS = 64         # seeded calibration windows, one .npy
P1_TIMES = {}              # (dtype, (G, M, K, N)) -> error, times, bound
FUSED_TOTALS = {}          # model -> check_fused's sums per forward
SERVE_RATES = {}           # model -> bf16 windows (clips) / s: host, card


def accumulation_bound(k):
    """The factor of sum |a b| within which an element of a bf16 product
    (f32 sums of ``k`` exact products) must lie of the exact value: the
    any-order bound k P1_BF16_BOUND, or beyond LONG_K the probabilistic
    LONG_K_LAMBDA 2^-24 sqrt(k)."""
    if k <= LONG_K:
        return k * P1_BF16_BOUND
    return LONG_K_LAMBDA * 2.0 ** -24 * math.sqrt(k)


def p1_bound(shape, dtype):
    """The least times (ms) of one product on an H100 SXM: A and B read
    once and C written once over the HBM rate (M K + N K + 4 M N bytes in
    int8, 2 M K + 2 N K + 4 M N in bf16), and 2 M N K operations over the
    int8 or bf16 tensor-core peak."""
    g, m, k, n = shape
    g = g or 1
    item = 1 if dtype == torch.int8 else 2
    nbytes = g * (item * (m * k + n * k) + 4 * m * n)
    return (1e3 * nbytes / PEAK_BYTES,
            1e3 * 2.0 * g * m * n * k / PEAK_FLOPS[dtype])


def p1_operands(shape, dtype, gen):
    g, m, k, n = shape
    lead = () if g is None else (g,)
    if dtype == torch.int8:
        return tuple(torch.randint(-128, 128, lead + dims, generator=gen,
                                   device="cuda", dtype=torch.int8)
                     for dims in ((m, k), (n, k)))
    return tuple(torch.randn(lead + dims, generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for dims in ((m, k), (n, k)))


def p1_library(a, b, dtype):
    """One PyTorch call computing the same product, the yardstick the
    port never calls, or None: ``torch._int_mm`` (cuBLASLt) with K and N
    zero-padded to multiples of 8 as it needs (exact: zeros add nothing),
    for M above 16 and no groups; ``torch.matmul`` in bf16 (its output
    bf16)."""
    import torch.nn.functional as F
    if dtype == torch.bfloat16:
        return lambda: torch.matmul(a, b.transpose(-1, -2))
    if a.dim() == 3 or a.shape[0] <= 16:
        return None
    k8, n8 = -(-a.shape[1] // 8) * 8, -(-b.shape[0] // 8) * 8
    ap = F.pad(a, (0, k8 - a.shape[1]))
    bp = F.pad(b, (0, k8 - b.shape[1], 0, n8 - b.shape[0]))
    for bt in (bp.t(), bp.t().contiguous()):      # the layouts it may take
        try:
            torch._int_mm(ap, bt)
            return lambda: torch._int_mm(ap, bt)
        except RuntimeError as e:
            print(f"torch._int_mm at {tuple(ap.shape)} x {tuple(bt.shape)} "
                  f"(strides {bt.stride()}): {str(e).splitlines()[0]}")
    return None


def p1_case(shape, dtype, gen):
    """One shape of P1 on the card, once: the kernel against its plain
    version (s8 exactly; bf16 within ``accumulation_bound`` of the exact
    product), then plain, kernel, kernel, plain and the library call timed
    with CUDA events, and the bound. Kept in P1_TIMES."""
    from multi_modal_csi_tpu_torch.kernels import int8_matmul as K
    if (dtype, shape) in P1_TIMES:
        return P1_TIMES[(dtype, shape)]
    g, m, k, n = shape
    a, b = p1_operands(shape, dtype, gen)
    if dtype == torch.int8:
        kernel, plain = K.int8_matmul, K.int8_matmul_reference
        got, want = kernel(a, b), plain(a, b)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"P1 s8 {shape}: not equal to the exact product")
        err, worst = 0.0, 0.0
    else:
        kernel, plain = K.bf16_matmul_f32, K.bf16_matmul_f32_reference
        got, want = kernel(a, b), plain(a, b)
        ad, bd = a.double(), b.double().transpose(-1, -2)
        bound = accumulation_bound(k) * (ad.abs() @ bd.abs())
        worst = float(((got.double() - ad @ bd).abs()
                       / bound.clamp_min(1e-300)).max())
        del ad, bd, bound
        check(got.dtype == torch.float32 and worst <= 1.0,
              f"P1 bf16 {shape}: {worst:.3g} of its accumulation bound "
              f"from the exact product")
        err = float((got - want).abs().max())
    del got, want
    reps = max(3, min(20, int(4e10 / ((g or 1) * m * k * n))))
    times = [cuda_ms(lambda: plain(a, b), reps, 1)]
    times += [cuda_ms(lambda: kernel(a, b), reps, 1) for _ in range(2)]
    times.append(cuda_ms(lambda: plain(a, b), reps, 1))
    lib = p1_library(a, b, dtype)
    lib_ms = None if lib is None else cuda_ms(lib, reps, 1)
    bytes_ms, ops_ms = p1_bound(shape, dtype)
    row = dict(err=err, ms=(times[1] + times[2]) / 2,
               plain_ms=(times[0] + times[3]) / 2, library_ms=lib_ms,
               bytes_ms=bytes_ms, ops_ms=ops_ms)
    P1_TIMES[(dtype, shape)] = row
    name = "s8" if dtype == torch.int8 else "bf16"
    lib_text = "none" if lib_ms is None else f"{lib_ms:.4f}"
    print(f"P1 {name} G,M,K,N={shape}: "
          + ("exact" if dtype == torch.int8 else
             f"max abs err vs plain {err:.3e}, {worst:.3g} of the bound")
          + f"; kernel {times[1]:.4f}/{times[2]:.4f} ms, plain "
          f"{times[0]:.4f}/{times[3]:.4f} ms, library {lib_text} ms; bound"
          f" bytes {1e3 * bytes_ms:.1f} us, operations {1e3 * ops_ms:.1f} "
          f"us")
    del a, b
    torch.cuda.empty_cache()
    return row


def phase_p1():
    """P1's two instantiations against their plain versions on the card
    at P1's own tile, every product of DETR's, THAT_ENCODER's, CNN-1D's
    and MLP's bs256 int8 forwards, and odd shapes (MLP's layer_0 as
    bf16 x int8, ``p1_w8_case``); a K that could overflow int32 must
    raise."""
    from multi_modal_csi_tpu_torch.kernels import int8_matmul as K
    pytorch_defaults()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = [(None, *P1_TILE)]
    # MLP w8's layer_0 (K = 810,000) is p1_w8_case's: its int8 x int8
    # product could overflow int32
    for table in (DETR_S8, DETR_BF16, ENCODER_S8, ENCODER_BF16, CNN1D_S8,
                  MLP_BF16):
        shapes += [(None, *mkn) for mkn in table
                   if (None, *mkn) not in shapes and mkn != MLP_W8_SHAPE]
    shapes += P1_ODD
    start = time.perf_counter()
    for shape in shapes:
        for dtype in (torch.int8, torch.bfloat16):
            p1_case(shape, dtype, gen)
    big = torch.zeros((2, K.MAX_K_S8 + 1), dtype=torch.int8, device="cuda")
    try:
        K.int8_matmul(big, big)
        refused = False
    except ValueError as e:
        print(f"P1 s8 K={K.MAX_K_S8 + 1}: refused ({e})")
        refused = True
    check(refused, "P1 s8 launched with a K whose sum could overflow")
    p1_w8_case(gen)
    phase_p1_fused(gen)
    phase_conv3d_odd(gen)
    print(f"P1 phase: {len(shapes)} shapes x 2, the fused path at "
          f"{len(P1_ODD)} x 2 and the implicit conv at {len(CONV3D_ODD)} x 2"
          f" in {time.perf_counter() - start:.1f} s")


def p1_w8_case(gen):
    """P1's bf16 x int8 product at MLP w8's layer_0, (256, 810000) x
    (256, 810000), through ``quantized_product`` with unit scales: within
    ``accumulation_bound`` (the long-K one) of the exact product, beside
    its plain version ``bf16_matmul_f32_reference`` on the weight widened
    to bf16, whose own distance is printed. The same check must refuse an
    all-zero output and the kernel's output without one split of K (the
    span the launcher gives each of ``split_count``'s splits: whole
    STAGE_VALUES stages, ceil(stages / splits) of them) or without one
    stage. Then the kernel's, plain version's and bf16 ``torch.matmul``'s
    times and the bound (A in bf16 and B in int8 read once, the f32 output
    written once; 2 M N K operations at the bf16 peak). Kept in
    P1_TIMES."""
    from multi_modal_csi_tpu_torch.kernels import int8_matmul as K
    m, k, n = MLP_W8_SHAPE
    a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    ones = torch.ones(n, device="cuda")

    def kernel():
        return K.quantized_product(a, b, ones, None, None, torch.float32,
                                   k=k)

    wide = b.to(torch.bfloat16)

    def plain():
        return K.bf16_matmul_f32_reference(a, wide)

    got, want = kernel(), plain()
    err = float((got - want).abs().max())
    ad, bd = a.double(), b.double().t()
    exact = ad @ bd
    tol = accumulation_bound(k) * (ad.abs() @ bd.abs())
    tol = tol.clamp_min(1e-300)

    def worst(c):
        return float(((c.double() - exact).abs() / tol).max())

    splits = K.split_count(1, m, n, 2 * k)
    span = STAGE_VALUES * -(-(-(-k // STAGE_VALUES)) // splits)
    mid = splits // 2 * span
    readings = {
        "kernel": worst(got), "plain version": worst(want),
        "all-zero output": worst(torch.zeros_like(got)),
        f"kernel without split {splits // 2} (K {mid}:{mid + span})": worst(
            got.double() - ad[:, mid:mid + span] @ bd[mid:mid + span]),
        f"kernel without one stage (K {mid}:{mid + STAGE_VALUES})": worst(
            got.double() - ad[:, mid:mid + STAGE_VALUES]
            @ bd[mid:mid + STAGE_VALUES])}
    del ad, bd, exact, tol, got, want
    print(f"P1 bf16 x int8 M,K,N={MLP_W8_SHAPE} (MLP w8 layer_0), of the "
          f"bound {LONG_K_LAMBDA} 2^-24 sqrt(K) sum|ab| from the exact "
          f"product: " + "; ".join(f"{name} {r:.3g}" for name, r
                                   in readings.items()))
    check(readings["kernel"] <= 1.0,
          f"P1 bf16 x int8 {MLP_W8_SHAPE}: {readings['kernel']:.3g} of its "
          f"accumulation bound from the exact product")
    check(all(r > 1.0 for name, r in list(readings.items())[2:]),
          f"P1 bf16 x int8 {MLP_W8_SHAPE}: the check passed a wrong output "
          f"{readings}")
    times = [cuda_ms(plain, 5, 1)]
    times += [cuda_ms(kernel, 5, 1) for _ in range(2)]
    times.append(cuda_ms(plain, 5, 1))
    lib_ms = cuda_ms(lambda: torch.matmul(a, wide.t()), 5, 1)
    bytes_ms = 1e3 * (2 * m * k + n * k + 4 * m * n) / PEAK_BYTES
    ops_ms = 1e3 * 2.0 * m * n * k / PEAK_FLOPS[torch.bfloat16]
    row = dict(err=err, ms=(times[1] + times[2]) / 2,
               plain_ms=(times[0] + times[3]) / 2, library_ms=lib_ms,
               bytes_ms=bytes_ms, ops_ms=ops_ms)
    P1_TIMES[(torch.bfloat16, (None, *MLP_W8_SHAPE))] = row
    print(f"P1 bf16 x int8 M,K,N={MLP_W8_SHAPE} (MLP w8 layer_0): max abs "
          f"err vs plain {err:.3e}; "
          f"{-(-m // K.TILE_M) * -(-n // K.TILE_N)} output tiles, "
          f"split_count {splits}; kernel {times[1]:.4f}/{times[2]:.4f} ms, "
          f"plain {times[0]:.4f}/{times[3]:.4f} ms, library (bf16 "
          f"torch.matmul) {lib_ms:.4f} ms; bound bytes {bytes_ms:.4f} ms, "
          f"operations {ops_ms:.4f} ms")
    del a, b, wide
    torch.cuda.empty_cache()
    return row


def phase_fits():
    """Each instantiation at the largest shape that its fit predicate
    admits: launched; one step beyond: refused with ValueError. K2 in both
    dtypes, whose tensor-core kernels stream their tiles, at 64 tokens of
    a head of 128, and a head of 129, and at 640 tokens of D = 27 (the
    JAX gate's, past the 457 of bf16's CUDA-core kernel before them) held
    against its plain version within BWD_TOL; K1 in both dtypes, whose
    tensor-core bodies stream the keys, at 4096 keys of a head of 128,
    and a head of 129; K3 in both dtypes at the largest bias rank M and
    head dim D that ``lowrank_fits`` admits, and one more of each. The
    predicates and the C launchers agree."""
    from multi_modal_csi_tpu_torch.kernels.flash_attention import (
        backward_fits, flash_attention, flash_attention_backward,
        flash_attention_backward_reference, forward_fits)
    from multi_modal_csi_tpu_torch.kernels.flash_attention_lowrank import (
        flash_attention_lowrank_bias, lowrank_fits)
    f32, bf16 = torch.float32, torch.bfloat16
    d = 27
    d2 = {dtype: max(n for n in range(1, 512) if backward_fits(64, 64, n,
                                                               dtype))
          for dtype in (f32, bf16)}
    dk = {dtype: max(n for n in range(1, 512) if forward_fits(4096, n, dtype))
          for dtype in (f32, bf16)}
    print(f"fit predicates: K2 up to D={d2[f32]} (f32) and {d2[bf16]} "
          f"(bf16) at any Nq and Nk, K1 up to D={dk[f32]} (f32) and "
          f"{dk[bf16]} (bf16) at any Nk")

    def k1(size, dim, dtype):
        t = torch.randn((1, size, 1, dim), device="cuda").to(dtype)
        flash_attention(t[:, :64], t, t)

    def k2(size, dim, dtype):
        t = torch.randn((1, size, 1, dim), device="cuda").to(dtype)
        flash_attention_backward(t, t, t, t)

    cases = [(f"K2 {DTYPE_NAMES[dtype]}", k2, dtype, 64, n, n == d2[dtype])
             for dtype in (f32, bf16) for n in (d2[dtype], d2[dtype] + 1)]
    cases += [(f"K1 {DTYPE_NAMES[dtype]}", k1, dtype, 4096, n, n == dk[dtype])
              for dtype in (f32, bf16) for n in (dk[dtype], dk[dtype] + 1)]
    for what, call, dtype, size, dim, fits in cases:
        try:
            call(size, dim, dtype)
            torch.cuda.synchronize()
            launched = True
            print(f"{what} at {size} tokens, D={dim}: launched")
        except ValueError as e:
            print(f"{what} at {size} tokens, D={dim}: refused ({e})")
            launched = False
        check(launched == fits, f"{what} at {size} tokens, D={dim}: "
                                f"launched {launched}, predicate {fits}")

    # K2 past the old bf16 kernel's limit: 640 tokens of THAT's head dim
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in (f32, bf16):
        q, k, v, do = (torch.randn((1, 640, 1, d), generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(4))
        got = flash_attention_backward(q, k, v, do)
        want = flash_attention_backward_reference(q, k, v, do)
        torch.cuda.synchronize()
        errs = [((g.float() - w.float()).abs().max()
                 / w.float().abs().max()).item() for g, w in zip(got, want)]
        print(f"K2 {DTYPE_NAMES[dtype]} at 640 tokens, D={d}: launched; dq, "
              f"dk, dv within " + ", ".join(f"{e:.3e}" for e in errs)
              + f" of each max (tolerance {BWD_TOL[dtype]:.0e})")
        check(all(e <= BWD_TOL[dtype] for e in errs),
              f"K2 {dtype} at 640 tokens: {errs}")

    mk = max(n for n in range(512) if lowrank_fits(96, n))
    dl = max(n for n in range(1, 512) if lowrank_fits(n, mk))
    print(f"fit predicate: K3 up to M={mk} at D=96, D={dl} at M={mk}")
    for dtype in (f32, bf16):
        for rank, dim in ((mk, 96), (mk + 1, 96), (mk, dl), (mk, dl + 1)):
            q = torch.randn((1, 1, 256, dim), device="cuda").to(dtype)
            kv = torch.randn((1, 1, 1128, dim), device="cuda").to(dtype)
            what = f"K3 {dtype} at M={rank}, D={dim}, 1128 keys"
            try:
                flash_attention_lowrank_bias(
                    q, kv, kv, torch.randn((1, 1, 256, rank), device="cuda"),
                    torch.randn((rank, 1128), device="cuda"))
                torch.cuda.synchronize()
                launched = True
                print(f"{what}: launched")
            except ValueError as e:
                print(f"{what}: refused ({e})")
                launched = False
            fits = lowrank_fits(dim, rank)
            check(launched == fits, f"{what}: launched {launched}, "
                                    f"predicate {fits}")


@contextlib.contextmanager
def recorded_launches():
    """Records (A's dtype, G, M, K, N) of every P1 launch inside the
    block, K the true width and N per group."""
    from multi_modal_csi_tpu_torch.kernels import int8_matmul as K
    real, shapes = K._launch, []

    def launch(a, b, out, **kw):
        shapes.append((a.dtype, kw["groups"], kw["m"], kw["k"], kw["n"]))
        real(a, b, out, **kw)
    K._launch = launch
    try:
        yield shapes
    finally:
        K._launch = real


@contextlib.contextmanager
def recorded_activations():
    """Keeps a CPU copy of every int8 operand that the quantized layers'
    prologues (1-D and 3-D) make inside the block: the implicit conv's
    codes are the 1-D prologue's at k = 1."""
    from multi_modal_csi_tpu_torch.core import quantize as Q
    real, real3d, out = Q.quantize_columns, Q.quantize_columns3d, []

    def keeping(fn):
        def quantize(x, scale, *args):
            q = fn(x, scale, *args)
            if scale is not None:
                out.append(q.cpu())
            return q
        return quantize
    Q.quantize_columns, Q.quantize_columns3d = keeping(real), keeping(real3d)
    try:
        yield out
    finally:
        Q.quantize_columns, Q.quantize_columns3d = real, real3d


def by_shape(shapes, dtype):
    """Launch counts by (M, K, N) of the ungrouped launches of ``dtype``."""
    from collections import Counter
    return Counter((m, k, n) for t, g, m, k, n in shapes
                   if t == dtype and g == 1)


def int8_serve_phase(key, requests, calib_path, s8_table, bf16_table,
                     columns, expect_out, k1_per_forward, quant="auto",
                     mode="w8a8"):
    """int8 serving of ``key`` (``quant``: "auto" takes QUANT_DEFAULTS;
    it must resolve to ``mode``) in bf16 at batch 256, calibrated on the
    .npy at ``calib_path`` through CSIServer: exact P1 launches by shape
    in one batch forward (``columns`` None: a model of int8 convs, whose
    launches ``int8_conv_launches`` gives), every prologue, fused product
    and implicit conv of it held
    against its plain version, the ragged requests from host memory,
    rates, a profile with P1's share; the logits against bf16 serving
    (within INT8_SPREAD_BOUND where the JAX package has a bound); then, in
    w8a8, the same int8 weights at f32 on the card against the CPU, with
    the int8 activations that flipped."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.serving import CSIServer
    from multi_modal_csi_tpu_torch.runners.csi import build_model

    phase_start = time.perf_counter()
    pytorch_defaults()
    calib = np.load(calib_path)
    start = time.perf_counter()
    server = CSIServer(key, build_model(key, seed=SEED), dtype="bfloat16",
                       device="cuda", quant=quant, calib=calib)
    torch.cuda.synchronize()
    scales = [b for n, b in server.model.named_buffers()
              if n.endswith("input_scale")]
    int8 = {n for n, p in server.model.named_parameters()
            if p.dtype == torch.int8}
    print(f"{key}: quant {server.quant}, {len(int8)} int8 weights, "
          f"{len(scales)} input scales, calibrated on {len(calib)} windows "
          f"in {time.perf_counter() - start:.1f} s")
    check(server.quant == mode, f"{key} resolved quant {server.quant}")
    server(requests[0][:server.batch])                        # warm-up
    torch.cuda.synchronize()

    batch = torch.from_numpy(requests[0][:server.batch])
    kernels.reset_launch_counts()
    with recorded_launches() as shapes, int8_inputs(server.model) as inputs:
        server.forward(batch)
        torch.cuda.synchronize()
    one = dict(kernels.LAUNCH_COUNTS)
    want = {name: count for name, count in (
        (S8, sum(s8_table.values())), (BF16, sum(bf16_table.values())),
        (COLUMNS, columns), ("flash_attention", k1_per_forward)) if count}
    if columns is None:
        want = int8_conv_launches(server.model, inputs)
    print(f"{key} {mode}: launches in one batch forward: {one}")
    check(one == want, f"{key} {mode} launched {one}, expected {want}")
    check(by_shape(shapes, torch.int8) == s8_table
          and by_shape(shapes, torch.bfloat16) == bf16_table,
          f"{key} {mode} product shapes {sorted(set(shapes), key=str)}")
    # the prologue and the fused product at every call of a forward
    with captured_calls() as calls:
        server.forward(batch)
        torch.cuda.synchronize()
    FUSED_TOTALS[key] = check_fused(f"{key} {mode}", calls)
    del calls

    # the main path: ragged requests from host memory to logits on the host
    label = f"{key} {mode} bf16"
    timed = key not in BASELINES          # the baselines: not timed
    launches = host_and_card_rates(label, server, requests,
                                   RESIDENT_ROUNDS if timed else 0,
                                   expect_out, "windows")[1]
    batches = sum(-(-len(r) // server.batch) for r in requests)
    print(f"{label}: main path ran {batches} batch forwards, launches "
          f"{launches}")
    check(launches == {name: count * batches for name, count in
                       want.items()}, f"{key} {mode} launches {launches}")
    bf16_host, bf16_card = SERVE_RATES[key]
    print(f"{label}: bf16 serving {bf16_host:.1f} windows/s from host "
          f"memory, " + (", ".join(f"{r:.1f}" for r in bf16_card)
                         + " windows/s with the requests on the card"
                         if bf16_card else "not timed on the card"))
    if timed:
        batch = batch.cuda()
        prof = profile_device(f"{key} {mode}",
                              lambda: server.forward(batch),
                              PROFILED_FORWARDS, "forward")
        int8_shares(f"{key} {mode}", prof)
    del batch

    # the logits against bf16 serving of the same seeded weights
    x = requests[1]
    got = server(x).cpu().numpy()
    ref = CSIServer(key, build_model(key, seed=SEED), dtype="bfloat16",
                    device="cuda")(x).cpu().numpy()
    spread = float(np.abs(got - ref).max() / (ref.std() + 1e-9))
    bound = INT8_SPREAD_BOUND.get(key)
    print(f"{key} {mode} vs bf16 serving on {len(x)} windows: max abs diff "
          f"{np.abs(got - ref).max():.4f} = {spread:.4f} of the bf16 "
          f"logits' spread ("
          + (f"bound {bound})" if bound else "the JAX package has no bound "
             "for it)"))
    check(bound is None or spread < bound, f"{key} {mode} vs bf16 {spread}")
    del server
    if mode != "w8a8":
        print(f"{key} {mode} serving phase: "
              f"{time.perf_counter() - phase_start:.1f} s")
        return launches

    # the same int8 weights and scales at f32: the CPU (plain versions)
    # against the card (default flags), 4 windows
    pytorch_defaults()
    x = requests[1][:4]
    cpu = CSIServer(key, build_model(key, seed=SEED), dtype="float32",
                    device="cpu", batch=4, quant="w8a8", calib=calib[:4])
    with recorded_activations() as cpu_acts:
        want_out = cpu(x).numpy()
    card = CSIServer(key, cpu.model, dtype="float32", device="cuda",
                     batch=4)
    kernels.reset_launch_counts()
    with recorded_activations() as card_acts:
        got_out = card(x).cpu().numpy()
    card_launches = dict(kernels.LAUNCH_COUNTS)
    check(all(card_launches.get(n) == want.get(n) for n in (S8, CONV3D)),
          f"{key} f32 int8 on the card launched {card_launches}")
    check(len(card_acts) == len(cpu_acts), f"{key}: {len(card_acts)} "
          f"quantized activations on the card, {len(cpu_acts)} on the CPU")
    flips = [int((a != b).sum()) for a, b in zip(cpu_acts, card_acts)]
    steps = [int((a.int() - b.int()).abs().max())
             for a, b in zip(cpu_acts, card_acts)]
    err = float(np.abs(got_out - want_out).max())
    top = float(np.abs(want_out).max())
    print(f"{key} w8a8 f32 card vs CPU: max abs err {err:.3e} (tolerance "
          f"{INT8_CPU_SHARE} x {top:.4f}); int8 activations flipped: "
          f"{sum(flips)} of {sum(a.numel() for a in cpu_acts)} over "
          f"{len(flips)} quantized layers, by at most {max(steps)}; at the "
          f"first layer {flips[0]} of {cpu_acts[0].numel()}, by at most "
          f"{steps[0]}")
    # the first quantized layer's input differs between the devices by f32
    # noise only, so an activation can only land on the other side of one
    # rounding boundary; later layers inherit the flips before them
    check(steps[0] <= 1, f"{key} first int8 activations differ by "
                         f"{steps[0]}")
    check(err <= INT8_CPU_SHARE * top, f"{key} w8a8 card vs CPU {err}")
    print(f"{key} {mode} serving phase: "
          f"{time.perf_counter() - phase_start:.1f} s")
    return launches


def int8_cli_phase(calib_path):
    """cli/serve_csi.py --model DETR --quant auto --calib F.npy on the
    card: its default requests, w8a8, exact P1 launches."""
    import io
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.cli import serve_csi
    kernels.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_csi.main(["--model", "DETR", "--quant", "auto", "--calib",
                        calib_path])
    text = out.getvalue()
    print(text, end="")
    launches = dict(kernels.LAUNCH_COUNTS)
    # the warm-up request and then 256, 100 and 300 windows: 1 + 1 + 1 + 2
    # batch forwards
    forwards = 5
    want = {S8: sum(DETR_S8.values()) * forwards,
            BF16: sum(DETR_BF16.values()) * forwards,
            COLUMNS: DETR_COLUMNS * forwards}
    check("quant w8a8" in text and launches == want,
          f"serve_csi --quant auto launched {launches}, expected {want}")
    return launches


def video_int8_phase(requests):
    """MViT-v2 w8 serving at full width, bf16, batch 2 (the hooked set
    discovered with one zero clip): exactly 16 K3 and
    MVIT_BF16_PER_FORWARD bf16 products per batch forward and no s8; the
    logits against bf16 serving; clips/s; P1 held against its plain
    version at each product shape of the forward."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.serving import VideoServer
    from multi_modal_csi_tpu_torch.nn.layers import Linear
    from multi_modal_csi_tpu_torch.runners.video import build_video_model
    key = "MViT-v2"
    pytorch_defaults()
    server = VideoServer(key, build_video_model(key, VIDEO_OUT, VIDEO_CLIP,
                                                seed=SEED),
                         dtype="bfloat16", device="cuda", quant="w8")
    linears = [m for m in server.model.modules() if isinstance(m, Linear)
               and m.weight.dtype == torch.int8]
    print(f"{key} w8: {len(linears)} int8 Linears")
    check(server.quant == "w8" and len(linears) == MVIT_BF16_PER_FORWARD,
          f"{key} w8 quantized {len(linears)} Linears")
    server(requests[0])                                       # warm-up
    torch.cuda.synchronize()
    batch = torch.from_numpy(requests[0][:server.batch]).cuda()
    kernels.reset_launch_counts()
    with recorded_launches() as shapes:
        server.forward(batch)
        torch.cuda.synchronize()
    one = dict(kernels.LAUNCH_COUNTS)
    want = {K3: K3_PER_FORWARD, BF16: MVIT_BF16_PER_FORWARD}
    print(f"{key} w8: launches in one batch forward: {one}")
    check(one == want, f"{key} w8 launched {one}, expected {want}")
    with captured_calls() as calls:
        server.forward(batch)
        torch.cuda.synchronize()
    FUSED_TOTALS[key] = check_fused(f"{key} w8", calls)
    del calls

    kernels.reset_launch_counts()
    start = time.perf_counter()
    outs = [server(r).cpu() for r in requests]
    host_s = time.perf_counter() - start
    launches = dict(kernels.LAUNCH_COUNTS)
    batches = sum(-(-len(r) // server.batch) for r in requests)
    n = sum(len(r) for r in requests)
    for r, out in zip(requests, outs):
        check(tuple(out.shape) == (len(r), VIDEO_OUT)
              and bool(torch.isfinite(out).all()),
              f"{key} w8 output {tuple(out.shape)} not finite")
    check(launches == {name: c * batches for name, c in want.items()},
          f"{key} w8 main path launched {launches}")
    resident = [torch.from_numpy(r).cuda() for r in requests]
    rates = []
    for _ in range(RESIDENT_ROUNDS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for r in resident:
            server(r)
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - start))
    bf16_host, bf16_card = SERVE_RATES[key]
    print(f"{key} w8 bf16 batch 2: main path launches {launches}; "
          f"{n / host_s:.2f} clips/s from host memory (bf16 serving "
          f"{bf16_host:.2f}); with the clips on the card: "
          + ", ".join(f"{r:.2f}" for r in rates) + " clips/s (bf16 "
          + ", ".join(f"{r:.2f}" for r in bf16_card) + ")")
    prof = profile_device(f"{key} w8", lambda: server.forward(batch),
                          PROFILED_FORWARDS, "forward")
    int8_shares(f"{key} w8", prof)
    del resident
    got = outs[0].numpy()
    ref = VideoServer(key, build_video_model(key, VIDEO_OUT, VIDEO_CLIP,
                                             seed=SEED),
                      dtype="bfloat16", device="cuda")(
                          requests[0]).cpu().numpy()
    spread = float(np.abs(got - ref).max() / (ref.std() + 1e-9))
    print(f"{key} w8 vs bf16 serving: max abs diff "
          f"{np.abs(got - ref).max():.4f} = {spread:.4f} of the bf16 "
          f"logits' spread (bound {INT8_SPREAD_BOUND[key]})")
    check(spread < INT8_SPREAD_BOUND[key], f"{key} w8 vs bf16 {spread}")
    del server, outs
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    table = by_shape(shapes, torch.bfloat16)
    for mkn in sorted(table):
        for dtype in (torch.int8, torch.bfloat16):
            p1_case((None, *mkn), dtype, gen)
    p1_totals(f"{key} w8", table, torch.bfloat16)
    return launches


# ---------------------------------------------------------------------- #
# the fused path of int8 serving: prologue (quantize_columns) and the
# product with its epilogue (quantized_product)
# ---------------------------------------------------------------------- #

@contextlib.contextmanager
def captured_calls():
    """Keeps, for each signature of a prologue (1-D or 3-D),
    fused-product or implicit-conv call that the quantized layers make
    inside the block (kind, dtypes, shapes, options), the first call's
    arguments and how often it ran: key -> [args, kwargs, count]."""
    from multi_modal_csi_tpu_torch.core import quantize as Q
    real_columns, real_product = Q.quantize_columns, Q.quantized_product
    real_columns3d, real_conv3d = Q.quantize_columns3d, Q.quantized_conv3d
    calls = {}

    def keep(key, args, kwargs):
        calls.setdefault(key, [args, kwargs, 0])[2] += 1

    def columns(x, scale, *args):
        keep(("columns", x.dtype, tuple(x.shape), scale is None, args),
             (x, scale) + args, {})
        return real_columns(x, scale, *args)

    def columns3d(x, scale, *args):
        keep(("columns3d", x.dtype, tuple(x.shape), scale is None, args),
             (x, scale) + args, {})
        return real_columns3d(x, scale, *args)

    def product(a, b, ws, s, bias, out_dtype, *, k):
        keep(("product", a.dtype, tuple(a.shape), tuple(b.shape), k,
              out_dtype, bias is not None), (a, b, ws, s, bias, out_dtype),
             {"k": k})
        return real_product(a, b, ws, s, bias, out_dtype, k=k)
    def conv3d(a, b, ws, s, bias, out_dtype, kernel, stride, pads):
        keep(("conv3d", a.dtype, tuple(a.shape), tuple(b.shape),
              tuple(kernel), tuple(stride), tuple(pads), out_dtype,
              bias is not None),
             (a, b, ws, s, bias, out_dtype, kernel, stride, pads), {})
        return real_conv3d(a, b, ws, s, bias, out_dtype, kernel, stride,
                           pads)
    Q.quantize_columns, Q.quantized_product = columns, product
    Q.quantize_columns3d, Q.quantized_conv3d = columns3d, conv3d
    try:
        yield calls
    finally:
        Q.quantize_columns, Q.quantized_product = real_columns, real_product
        Q.quantize_columns3d, Q.quantized_conv3d = real_columns3d, real_conv3d


def columns_bound(x, out):
    """The least time (ms) of one prologue call: x read once and the
    columns written once (the row pad not counted) over the HBM rate; its
    one division a value over the f32 peak."""
    nbytes = x.numel() * x.element_size() + out.numel() * out.element_size()
    return (1e3 * nbytes / PEAK_BYTES,
            1e3 * out.numel() / PEAK_FLOPS[torch.float32])


def product_shape(a, b, k):
    """(M, K, N) of a fused product: K the true width, N every group's."""
    return a.shape[0], k, b.shape[-2] * (b.shape[0] if b.dim() == 3 else 1)


def fused_bound(a, b, out_dtype, k):
    """The least times (ms) of one fused product: A (its true K columns)
    and B read once and the output written once in ``out_dtype`` over the
    HBM rate, and 2 M N K operations over the tensor-core peak of A's
    type."""
    m, _, n = product_shape(a, b, k)
    groups = b.shape[0] if b.dim() == 3 else 1
    out = torch.empty((), dtype=out_dtype).element_size()
    nbytes = m * k * groups * a.element_size() + n * k + m * n * out
    return (1e3 * nbytes / PEAK_BYTES,
            1e3 * 2.0 * m * n * k / PEAK_FLOPS[a.dtype])


def conv3d_shape(a, b, kernel, stride, pads):
    """(M, K, N) of an implicit conv: M output positions, K = kt kh kw
    Cp, N features."""
    from multi_modal_csi_tpu_torch.kernels.int8_matmul import conv3d_output
    dims = conv3d_output(tuple(a.shape[1:4]), kernel, stride, pads)
    return (a.shape[0] * math.prod(dims), math.prod(kernel) * a.shape[-1],
            b.shape[0])


def conv3d_bound(a, b, out_dtype, kernel, stride, pads):
    """The least times (ms) of one implicit conv: the codes (each read
    once, not once a tap), the weight's K columns and the output over the
    HBM rate, and 2 M N K operations over the tensor-core peak of the
    codes' type."""
    m, k, n = conv3d_shape(a, b, kernel, stride, pads)
    out = torch.empty((), dtype=out_dtype).element_size()
    nbytes = a.numel() * a.element_size() + n * k + m * n * out
    return (1e3 * nbytes / PEAK_BYTES,
            1e3 * 2.0 * m * n * k / PEAK_FLOPS[a.dtype])


def conv3d_bf16_worst(got, a, b, ws, bias, kernel, stride, pads):
    """``bf16_fused_worst`` of a bf16 implicit conv, over chunks of whole
    samples of its tap-major columns (the plain version's chunks)."""
    from multi_modal_csi_tpu_torch.kernels import int8_matmul as K
    m, k, n = conv3d_shape(a, b, kernel, stride, pads)
    per = m // a.shape[0]
    step = max(1, K.REFERENCE_ELEMENTS // (per * k))
    worst = 0.0
    for i in range(0, a.shape[0], step):
        cols = K.conv3d_columns(a[i:i + step], kernel, stride, pads)
        worst = max(worst, bf16_fused_worst(
            got[i:i + step].reshape(-1, n), cols, b, ws, bias, k))
        del cols
    return worst


def fused_library(a, b, ws, s, bias, out_dtype, k):
    """The yardstick of a fused product, or None (grouped, or M <= 16 for
    s8): ``torch._int_mm`` (w8a8) or bf16 ``torch.matmul`` (w8) on the
    unpadded operands, then the eager epilogue (times the scale, plus the
    bias, the cast)."""
    if b.dim() == 3:
        return None
    a2 = (a[:, 0] if a.dim() == 3 else a)[:, :k].contiguous()
    b2 = b[:, :k].contiguous()
    n = b.shape[0]
    dtype = a.dtype
    lib = p1_library(a2, b2 if dtype == torch.int8 else
                     b2.to(torch.bfloat16), dtype)
    if lib is None:
        return None
    scale = ws if s is None else ws * s

    def run():
        y = lib()[:, :n].float() * scale
        if bias is not None:
            y = y + bias
        return y.to(out_dtype)
    return run


def bf16_fused_worst(got, a, b, ws, bias, k):
    """The bf16 fused product's largest error against the exact value
    (float64) of the same epilogue, over its bound: ``accumulation_bound``
    (K 2^-23 sum |a b|, or the long-K bound beyond LONG_K) times |scale|,
    plus the epilogue's f32 roundings (2^-22 of |A B^T scale| + |bias|);
    for a bf16 output, plus half a bf16 step of the f32 value before the
    cast, at most 2^-8 of it."""
    m, _, n = product_shape(a, b, k)
    a3 = (a if a.dim() == 3 else a[:, None])[..., :k].double().transpose(0, 1)
    b3 = (b if b.dim() == 3 else b[None])[..., :k].double()
    y = (a3 @ b3.transpose(-1, -2)).transpose(0, 1).reshape(m, n)
    mag = (a3.abs() @ b3.abs().transpose(-1, -2)).transpose(0, 1).reshape(
        m, n)
    del a3, b3
    wsd = ws.double()
    bd = torch.zeros_like(wsd) if bias is None else bias.double()
    want = y * wsd + bd
    tol = (accumulation_bound(k) * mag * wsd.abs()
           + 2.0 ** -22 * ((y * wsd).abs() + bd.abs()))
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * (want.abs() + tol)
    return float(((got.double() - want).abs() / tol.clamp_min(1e-300))
                 .max())


@torch.no_grad()
def check_fused(label, calls, timed=lambda key: True):
    """Each captured prologue call against its plain version on the card
    (torch.equal: quantize_activation or the bf16 cast, unfold, pad), each
    captured fused product and implicit conv against the eager chain on
    the card (s8 and int8 codes: torch.equal; bf16: ``bf16_fused_worst``
    within 1); then per signature for which ``timed(key)`` holds, with
    CUDA events (plain, kernel, kernel, plain), their times beside the
    yardstick (prologue and implicit conv: none; product:
    ``fused_library``) and the bound. Returns the sums of the timed calls
    per forward (weights: the calls' counts) for the prologue, each
    product type and the implicit conv, with the largest error of all
    calls (0: equal)."""
    from multi_modal_csi_tpu_torch.kernels import int8_matmul as K
    fields = ("ms", "plain_ms", "bytes_ms", "ops_ms", "library_ms")
    totals = {name: dict.fromkeys(fields, 0.0)
              | {"err": 0.0, "calls": 0, "checked": 0}
              for name in ("columns", "columns3d", "s8", "bf16", "conv3d")}
    prologues = {"columns": (K.quantize_columns,
                             K.quantize_columns_reference,
                             "k,stride,dilation,pads,groups"),
                 "columns3d": (K.quantize_columns3d,
                               K.quantize_columns3d_reference,
                               "kernel,stride,pads")}
    for key, (args, kwargs, count) in sorted(calls.items(), key=str):
        if key[0] in prologues:
            kernel, plain, options = prologues[key[0]]
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"{label}: prologue {key} differs from its plain version")
            bytes_ms, ops_ms = columns_bound(args[0], got)
            name, err, lib, what = key[0], 0.0, None, (
                f"{'3-D ' if key[0] == 'columns3d' else ''}prologue x "
                f"{tuple(args[0].shape)} {str(args[0].dtype)[6:]} "
                f"{options}={args[2:] or (1,)} -> {str(got.dtype)[6:]} "
                f"{tuple(got.shape)}: equal")
            reps = max(3, min(20, int(4e9 / got.numel())))
        elif key[0] == "conv3d":
            kernel, plain = K.quantized_conv3d, K.quantized_conv3d_reference
            a, b, ws, s, bias, out_dtype, geometry = (*args[:6], args[6:])
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            m, k, n = conv3d_shape(a, b, *geometry)
            name = "conv3d"
            if a.dtype == torch.int8:
                err = 0.0
                check(torch.equal(got, want), f"{label}: implicit conv {key} "
                                              f"differs from the eager chain")
                result = "equal to the eager chain"
            else:
                worst = conv3d_bf16_worst(got, a, b, ws, bias, *geometry)
                check(worst <= 1.0, f"{label}: implicit conv bf16 {key}: "
                                    f"{worst:.3g} of its bound")
                err = float((got.float() - want.float()).abs().max())
                result = (f"max abs err vs eager {err:.3e}, {worst:.3g} of "
                          f"the bound")
            bytes_ms, ops_ms = conv3d_bound(a, b, out_dtype, *geometry)
            lib = None
            what = (f"implicit conv {str(a.dtype)[6:]} codes "
                    f"{tuple(a.shape)} kernel {tuple(geometry[0])} stride "
                    f"{tuple(geometry[1])} pads {tuple(geometry[2])} "
                    f"M,K,N={(m, k, n)} {'bias ' if bias is not None else ''}"
                    f"-> {str(out_dtype)[6:]}: {result}")
            reps = max(3, min(20, int(4e10 / (m * k * n))))
        else:
            kernel, plain = K.quantized_product, K.quantized_product_reference
            a, b, ws, s, bias, out_dtype = args
            k = kwargs["k"]
            got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
            torch.cuda.synchronize()
            m, _, n = product_shape(a, b, k)
            if a.dtype == torch.int8:
                name, err = "s8", 0.0
                check(torch.equal(got, want), f"{label}: fused s8 {key} "
                                              f"differs from the eager chain")
                result = "equal to the eager chain"
            else:
                name = "bf16"
                worst = bf16_fused_worst(got, a, b, ws, bias, k)
                check(worst <= 1.0, f"{label}: fused bf16 {key}: {worst:.3g}"
                                    f" of its bound")
                err = float((got.float() - want.float()).abs().max())
                result = (f"max abs err vs eager {err:.3e}, {worst:.3g} of "
                          f"the bound")
            bytes_ms, ops_ms = fused_bound(a, b, out_dtype, k)
            lib = fused_library(a, b, ws, s, bias, out_dtype, k)
            what = (f"fused {name} M,K,N={(m, k, n)} A {tuple(a.shape)} "
                    f"{'bias ' if bias is not None else ''}-> "
                    f"{str(out_dtype)[6:]}: {result}")
            reps = max(3, min(20, int(4e10 / (m * k * n))))
        del got, want
        total = totals[name]
        total["err"] = max(total["err"], err)
        total["checked"] += count
        if not timed(key):
            print(f"{label} {what}; {count}x a forward; not timed")
            continue
        times = [cuda_ms(lambda: plain(*args, **kwargs), reps, 1)]
        times += [cuda_ms(lambda: kernel(*args, **kwargs), reps, 1)
                  for _ in range(2)]
        times.append(cuda_ms(lambda: plain(*args, **kwargs), reps, 1))
        lib_ms = None if lib is None else cuda_ms(lib, reps, 1)
        if key[0] == "product" and a.dim() == 2 and (
                a.stride(0) * a.element_size()) % 16:
            # the alternative to the bf16 activation read as it is, with
            # 4-byte copies: staged by the prologue at a 16-byte stride,
            # then 16-byte copies
            staged = cuda_ms(lambda: kernel(K.quantize_columns(
                a[None], None), *args[1:], **kwargs), reps, 1)
            what += (f"; as it is ({a.stride(0) * 2}-byte rows) "
                     f"{(times[1] + times[2]) / 2:.4f} ms against staged "
                     f"{staged:.4f} ms")
        row = dict(ms=(times[1] + times[2]) / 2,
                   plain_ms=(times[0] + times[3]) / 2, bytes_ms=bytes_ms,
                   ops_ms=ops_ms, library_ms=lib_ms)
        for field in fields:
            if total[field] is not None:
                total[field] = (None if row[field] is None
                                else total[field] + count * row[field])
        total["calls"] += count
        lib_text = "none" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"{label} {what}; {count}x a forward; kernel {times[1]:.4f}/"
              f"{times[2]:.4f} ms, plain {times[0]:.4f}/{times[3]:.4f} ms, "
              f"library {lib_text} ms; bound bytes {1e3 * bytes_ms:.1f} us, "
              f"operations {1e3 * ops_ms:.1f} us")
        torch.cuda.empty_cache()
    for name, t in totals.items():
        if not t["calls"]:
            continue
        lib = t["library_ms"]
        what = {"columns": "prologue", "columns3d": "3-D prologue",
                "conv3d": "implicit conv"}
        calls = (f"{t['calls']} calls" if t["calls"] == t["checked"] else
                 f"the {t['calls']} timed of its {t['checked']} calls")
        print(f"{label} {what.get(name, name)} per "
              f"forward ({calls}): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f}'} ms; bound bytes "
              f"{t['bytes_ms']:.4f} ms, operations {t['ops_ms']:.4f} ms")
    return totals


def int8_shares(label, prof):
    """P1's (the product and split-K kernels), the implicit conv's, the
    prologues' and the remaining elementwise and copy kernels' device ms
    per forward and shares, from ``profile_device``."""
    groups = {"P1 (product_kernel, reduce_kernel)": (
                  lambda n: ("product_kernel" in n and "true>" not in n)
                  or "reduce_kernel" in n),
              "implicit conv (product_kernel<..., true>)": (
                  lambda n: "product_kernel" in n and "true>" in n),
              "prologue (columns_kernel)": lambda n: "columns_kernel" in n,
              "3-D prologue (columns3d_kernel)": (
                  lambda n: "columns3d_kernel" in n),
              "elementwise and copies": (
                  lambda n: "elementwise" in n or "Copy" in n)}
    for what, picks in groups.items():
        ms = sum(t for kname, t in prof["kernels"].items() if picks(kname))
        print(f"{label}: {what} {ms:.3f} ms of {prof['device_ms']:.3f} ms "
              f"device time per forward ({100 * ms / prof['device_ms']:.1f}"
              f"%)")


def phase_p1_fused(gen):
    """The fused path at P1's odd shapes: each (G, M, K, N) of P1_ODD as a
    Linear (G None) or a grouped k = 1 convolution, in w8a8 (f32 input,
    bf16 output) and in w8 (bf16 input, f32 output), with a bf16 bias,
    through core/quantize.py, every call held by ``check_fused``; then a
    bf16 A whose rows no copy of 4 bytes divides must be refused by the
    launcher, raising."""
    from multi_modal_csi_tpu_torch.core import quantize as Q
    from multi_modal_csi_tpu_torch.kernels import int8_matmul as K
    for shape in P1_ODD:
        g, m, k, n = shape
        groups = g or 1
        x = 3 * torch.randn((1, m, groups * k), generator=gen, device="cuda")
        w = torch.randint(-127, 128, (groups * n, k), generator=gen,
                          device="cuda", dtype=torch.int8)
        ws = 1e-3 + 1e-2 * torch.rand(groups * n, generator=gen,
                                      device="cuda")
        bias = torch.randn(groups * n, generator=gen,
                           device="cuda").to(torch.bfloat16)
        s = torch.tensor(0.05, device="cuda")
        for scale, x_dtype, out_dtype in ((s, torch.float32, torch.bfloat16),
                                          (None, torch.bfloat16,
                                           torch.float32)):
            xi = x.to(x_dtype)
            with captured_calls() as calls:
                if g is None:
                    Q.dense_forward(xi, w, ws, scale, bias, out_dtype,
                                    K.pad_columns(w))
                else:
                    Q.conv_forward(xi, w[..., None], ws, scale, pads=(0, 0),
                                   stride=1, dilation=1, groups=groups,
                                   bias=bias, out_dtype=out_dtype,
                                   padded=K.pad_columns(w))
            mode = "w8" if scale is None else "w8a8"
            check_fused(f"P1_ODD {shape} {mode}", calls)
    a = torch.zeros((4, 270), dtype=torch.bfloat16, device="cuda")[:, 1:]
    try:
        K.quantized_product(a, K.pad_columns(torch.zeros(
            (8, 269), dtype=torch.int8, device="cuda")), torch.ones(
                8, device="cuda"), None, None, torch.float32, k=269)
        refused = False
    except RuntimeError as e:
        print(f"P1 fused bf16 A with rows of 538 bytes at a 540-byte stride:"
              f" refused ({e})")
        refused = True
    check(refused, "P1 launched a product no copy width divides")


def phase_conv3d_odd(gen):
    """The implicit conv at CONV3D_ODD through core/quantize.py's
    conv_nd_forward, in w8a8 (f32 input, bf16 output) and w8 (bf16 input,
    read as it is, f32 output), with a bf16 bias, every call held by
    ``check_fused``; then codes one byte off 16-byte alignment must be
    refused by the launcher, raising."""
    from multi_modal_csi_tpu_torch.core import quantize as Q
    from multi_modal_csi_tpu_torch.kernels import int8_matmul as K
    for shape, n, kernel, stride, pads in CONV3D_ODD:
        x = 3 * torch.randn(shape, generator=gen, device="cuda")
        w = torch.randint(-127, 128, (n, shape[-1], *kernel), generator=gen,
                          device="cuda", dtype=torch.int8)
        ws = 1e-3 + 1e-2 * torch.rand(n, generator=gen, device="cuda")
        bias = torch.randn(n, generator=gen,
                           device="cuda").to(torch.bfloat16)
        s = torch.tensor(0.05, device="cuda")
        for scale, x_dtype, out_dtype in ((s, torch.float32, torch.bfloat16),
                                          (None, torch.bfloat16,
                                           torch.float32)):
            with captured_calls() as calls:
                Q.conv_nd_forward(x.to(x_dtype), w, ws, scale,
                                  stride=stride, padding=pads, bias=bias,
                                  out_dtype=out_dtype)
            check(sum(key[0] == "conv3d" for key in calls) == 1,
                  f"implicit conv {shape}: {sorted(calls, key=str)}")
            mode = "w8" if scale is None else "w8a8"
            check_fused(f"CONV3D_ODD {shape} {kernel} {mode}", calls)
    codes = torch.zeros(2 * 3 * 4 * 5 * 16 + 1, dtype=torch.int8,
                        device="cuda")[1:].view(2, 3, 4, 5, 16)
    taps = K.tap_major(torch.zeros((8, 16, 1, 1, 1), dtype=torch.int8,
                                   device="cuda"), 16)
    try:
        K.quantized_conv3d(codes, taps, torch.ones(8, device="cuda"),
                           torch.tensor(1.0, device="cuda"))
        refused = False
    except RuntimeError as e:
        print(f"implicit conv on codes one byte off alignment: refused ({e})")
        refused = True
    check(refused, "the implicit conv launched on misaligned codes")


def p1_totals(label, table, dtype):
    """P1's times and bound summed over one forward (``table``: (M, K, N)
    -> launches), printed under ``label``."""
    rows = [(P1_TIMES[(dtype, (None, *mkn))], count)
            for mkn, count in table.items()]
    total = {field: sum(count * r[field] for r, count in rows)
             for field in ("ms", "plain_ms", "bytes_ms", "ops_ms")}
    total["library_ms"] = (None if any(r["library_ms"] is None
                                       for r, _ in rows)
                           else sum(count * r["library_ms"]
                                    for r, count in rows))
    name = "s8" if dtype == torch.int8 else "bf16"
    lib = total["library_ms"]
    print(f"P1 {name} per {label} forward ({sum(table.values())} launches):"
          f" kernel {total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
          f"library {'none' if lib is None else f'{lib:.4f}'} ms; bound "
          f"bytes {total['bytes_ms']:.4f} ms, operations "
          f"{total['ops_ms']:.4f} ms")
    return total


def p1_entry(name, replaces, launches, table, dtype):
    """The JSON description of one of P1's instantiations: times and bound
    summed over one DETR w8a8 forward at bs256 (``table``: (M, K, N) ->
    launches); the error the largest over every shape held."""
    total = p1_totals("DETR w8a8", table, dtype)
    bytes_ms, ops_ms = total["bytes_ms"], total["ops_ms"]
    return {
        "name": name, "route": "cuda",
        "source": "multi_modal_csi_tpu_torch/kernels/csrc/int8_matmul.cu",
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["err"] for (t, _), r in P1_TIMES.items()
                           if t == dtype),
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": total["library_ms"],
    }


def columns_entry(launches):
    """The JSON description of the prologue: its times and bound summed
    over one DETR w8a8 forward at bs256, from ``check_fused``. No one
    PyTorch call computes the quantization with the unfold (library
    null). It replaces no TPU kernel of its own: it is the activation
    quantization that XLA fuses into P1's product in the JAX package."""
    total = FUSED_TOTALS["DETR"]["columns"]
    bytes_ms, ops_ms = total["bytes_ms"], total["ops_ms"]
    return {
        "name": COLUMNS, "route": "cuda",
        "source": "multi_modal_csi_tpu_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "multi_modal_csi_tpu/core/quantize.py:90",
        "launches": launches, "max_abs_err": total["err"],
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def build_kernels():
    """Build every kernel, one nvcc for each source, started together."""
    from multi_modal_csi_tpu_torch.kernels import build

    def timed(name):
        start = time.perf_counter()
        build.load(name)
        return time.perf_counter() - start

    names = ("flash_attention", "flash_attention_bwd",
             "flash_attention_lowrank", "flash_attention_lowrank_bwd",
             "csi_preprocess", "int8_matmul")
    start = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        took = dict(zip(names, pool.map(timed, names)))
    print(f"kernels built and loaded in {time.perf_counter() - start:.1f} s: "
          + ", ".join(f"{n} {t:.1f} s" for n, t in took.items()))
    for name in names:
        for kernel, line in ptxas_lines(build.LOGS.get(name, "")):
            print(f"  ptxas {name}: {kernel}: {line}")


def ptxas_lines(log):
    """(kernel, "registers ...; spills ...") for each kernel in an nvcc
    ``-Xptxas -v`` log; the tensor-core attention's instantiations named
    by their template arguments, ``tc::attention_kernel<k-steps, bias>``
    (bf16) and ``tc::attention_f32_kernel<k-steps, bias, warps, keys,
    blocks an SM>``."""
    import re
    out, kernel, spill = [], "?", ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = entry.group(1)
            tc = re.match(r"_ZN2tc(\d+)", kernel)
            if tc:
                start = tc.end()
                name = kernel[start:start + int(tc.group(1))]
                args = [("true" if v == "1" else "false") if t == "b" else v
                        for t, v in re.findall(
                            r"L([ib])(\d+)E",
                            kernel[start + len(name):].split("EEv")[0])]
                kernel = f"tc::{name}<{', '.join(args)}>"
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append((kernel, f"{line.split(':', 1)[1].strip()}; {spill}"))
    return out


def kernel_entry(name, source, replaces, launches, times, per_call, dtype,
                 as_3xtf32=False):
    """The JSON description of one kernel: times and bound summed over the
    launches of one model call (``per_call``: shape name -> launches).
    ``as_3xtf32``: an f32 kernel on the tensor cores, bound with every
    product as 3xTF32 over the TF32 peak (the f32-peak bound beside it as
    ``bound_f32_peak_ms``)."""
    def total(field):
        return sum(n * times[(s, dtype)][field] for s, n in per_call.items())

    bytes_ms, f32_ms = total("bytes_ms"), total("ops_ms")
    ops_ms = total("tf32_ms") if as_3xtf32 else f32_ms
    entry = {
        "name": name, "route": "cuda",
        "source": f"multi_modal_csi_tpu_torch/kernels/csrc/{source}",
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(times[(s, dtype)]["err"] for s in per_call),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": total("library_ms"),
    }
    if as_3xtf32:
        entry["bound_f32_peak_ms"] = max(bytes_ms, f32_ms)
    return entry


def k4_entry(name, source, replaces, launches, times, part, dtype):
    """The JSON description of one of K4's kernels in ``dtype``: times and
    bound summed over one MViT-v2 training step of that dtype at batch 2
    (one launch at each of blocks 0-2, with the bias). ``library_ms`` is
    the backward of scaled_dot_product_attention in the dtype, which
    computes the gradients of both kernels at once, so both entries of a
    dtype carry it. ``bound_ms`` is the bound in the tensor-core kernels'
    form (``lowrank_bwd_bound``'s third time: f32 every product as 3xTF32;
    bf16 the head-dim products at the bf16 peak, the bias as 3xTF32), with
    the bound at the dtype's peak beside it (``bound_f32_peak_ms``; bf16
    ``bound_bf16_peak_ms``, the bias at the f32 peak)."""
    rows = [times[(f"{block}+bias", dtype)] for block in LOWRANK_BWD_SHAPES]
    bytes_ms = sum(r[part]["bytes_ms"] for r in rows)
    peak_ms = sum(r[part]["ops_ms"] for r in rows)
    form_ms = sum(r[part]["tf32_ms"] for r in rows)
    return {
        "name": name, "route": "cuda",
        "source": f"multi_modal_csi_tpu_torch/kernels/csrc/{source}",
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r[part]["err"] for r in rows),
        "ms": sum(r[part]["ms"] for r in rows),
        "plain_ms": sum(r[part]["plain_ms"] for r in rows),
        "bound_ms": max(bytes_ms, form_ms),
        "bound_by": "bytes" if bytes_ms >= form_ms else "operations",
        "library_ms": sum(r["library_ms"] for r in rows),
        f"bound_{DTYPE_NAMES[dtype]}_peak_ms": max(bytes_ms, peak_ms),
    }


# ---------------------------------------------------------------------- #
# the other four video backbones (ResNet3D-18, S3D, Swin3D-T, Swin3D-S):
# served at their serving batch and dtype, ResNet and S3D in w8a8 on P1
# with the 3-D prologue, CNN-2D's int8 Conv2d, one training step each and
# run_video of Swin-T
# ---------------------------------------------------------------------- #

BACKBONES = ("ResNet", "S3D", "Swin-T", "Swin-S")
INT8_BACKBONES = ("ResNet", "S3D")
# ragged requests of clips, the first a full serving batch
BACKBONE_REQUESTS = {"ResNet": (64, 20), "S3D": (32, 10),
                     "Swin-T": (2, 1, 3), "Swin-S": (2, 1, 3)}
# card vs CPU at f32, batch 1: the full clip where the CPU side takes a
# few seconds, else a shorter one (Swin's attention on the host)
BACKBONE_CPU_CLIPS = {"ResNet": (45, 112, 112), "S3D": (45, 224, 224),
                      "Swin-T": (16, 224, 224), "Swin-S": (16, 224, 224)}
# card vs CPU f32 training step, batch 2: clips small enough for the CPU
BACKBONE_STEP_CLIPS = {"ResNet": (8, 56, 56), "S3D": (8, 96, 96),
                       "Swin-T": (8, 112, 112), "Swin-S": (8, 112, 112)}
# w8a8 card vs CPU on the same int8 weights, batch 2: the CPU's int8
# product is a plain int32 matmul, so short clips
INT8_BACKBONE_CPU_CLIPS = {"ResNet": (8, 56, 56), "S3D": (8, 64, 64)}
BACKBONE_PROFILED = 3      # forwards (steps) under the profiler
# the backbones whose training step is also timed and profiled on the
# card; S3D's and Swin-S's steps (no hand kernel) run with every check but
# untimed, which made room for the parallel phase's tensor-parallel ways
BACKBONES_TIMED = ("ResNet", "Swin-T")
BACKBONE_CALIB_CLIPS = 8   # seeded calibration clips (amax)
# the gradient of a card step against float64 (the CPU's, with the card's
# kink sides and max-pool picks): within GRAD_F32_TOL of each tensor's
# scale, or within this many times the CPU f32 step's own distance from
# float64 where S3D's BatchNorms over few positions leave f32 less
GRAD_F64_RATIO = 2.0
# CNN-2D (bf16 serving, batch 256): stages 1 and 2 int8 (stage 0 never
# announces), each an implicit conv of 32 and 64 channels over the batch
# (``int8_conv_launches``): no product, no columns
# the int8 conv against cuDNN at ResNet's layer1 (64 clips of 45 x 56 x
# 56 x 64, 3x3x3, 64 features)
LAYER1_SHAPE = (64, 45, 56, 56, 64)


def backbone_requests(key):
    from multi_modal_csi_tpu_torch.runners.video import VIDEO_CLIPS
    rng = np.random.default_rng(SEED + 7)
    return [rng.standard_normal((n, *VIDEO_CLIPS[key], 3), dtype=np.float32)
            for n in BACKBONE_REQUESTS[key]]


def host_and_card_rates(label, server, requests, rounds,
                        expect_out=lambda n: (n, VIDEO_OUT), unit="clips"):
    """The ragged requests from host memory to logits on the host (each
    output's shape ``expect_out(len(request))``, f32 and finite), then
    ``rounds`` timings with the requests already on the card. Returns the
    logits, the launch counts of the host run, the host rate and the card
    rates."""
    from multi_modal_csi_tpu_torch import kernels
    kernels.reset_launch_counts()
    start = time.perf_counter()
    outs = [server(r).cpu() for r in requests]
    host_s = time.perf_counter() - start
    launches = dict(kernels.LAUNCH_COUNTS)
    for r, out in zip(requests, outs):
        check(tuple(out.shape) == expect_out(len(r))
              and out.dtype == torch.float32
              and bool(torch.isfinite(out).all()),
              f"{label} output {tuple(out.shape)} {out.dtype} not finite f32")
    n = sum(len(r) for r in requests)
    resident = ([torch.from_numpy(r).cuda() for r in requests]
                if rounds else [])
    rates = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for r in resident:
            server(r)
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - start))
    del resident
    batches = sum(-(-len(r) // server.batch) for r in requests)
    print(f"{label} batch {server.batch}: {n / host_s:.2f} {unit}/s from "
          f"host memory, {n} {unit} in {batches} batch forwards; "
          + (f"with the requests on the card, {rounds} timings: "
             + ", ".join(f"{r:.2f}" for r in rates) + f" {unit}/s"
             if rounds else "not timed on the card"))
    return outs, launches, n / host_s, rates


def backbone_serve_phase(key):
    """``key`` served at its serving batch and dtype (ResNet 64 and S3D 32
    clips in bf16, Swin 2 in f32) at full width from seeded weights: the
    ragged requests from host memory (no hand kernel on this path: exactly
    no launch), clips/s, the peak memory, a profile; then the f32 logits at
    batch 1 on the card (default flags) against the CPU within
    VIDEO_F32_SHARE of the largest, at BACKBONE_CPU_CLIPS. Returns the
    peak memory in GiB."""
    from multi_modal_csi_tpu_torch.core.config import (resolve_serving_batch,
                                                       resolve_serving_dtype)
    from multi_modal_csi_tpu_torch.core.serving import VideoServer
    from multi_modal_csi_tpu_torch.runners.video import build_video_model
    start = time.perf_counter()
    pytorch_defaults()
    requests = backbone_requests(key)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = VideoServer(key, build_video_model(key, VIDEO_OUT, seed=SEED),
                         device="cuda")
    want = resolve_serving_dtype("auto", key)
    check(str(server.dtype) == f"torch.{want}"
          and server.batch == resolve_serving_batch(key),
          f"{key} serves at batch {server.batch} in {server.dtype}")
    label = f"{key} {DTYPE_NAMES[server.dtype]}"
    server(requests[0])                                       # warm-up
    torch.cuda.synchronize()
    outs, launches, host, rates = host_and_card_rates(label, server,
                                                      requests,
                                                      RESIDENT_ROUNDS)
    check(not launches, f"{label} launched {launches}")
    SERVE_RATES[key] = (host, rates)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: peak memory {peak:.2f} GiB serving batches of "
          f"{server.batch}")
    batch = torch.from_numpy(requests[0][:server.batch]).cuda()
    profile_device(label, lambda: server.forward(batch), BACKBONE_PROFILED,
                   "forward")
    del server, batch, outs
    torch.cuda.empty_cache()

    # under PyTorch's default flags (cuDNN's TF32 on): the port's convs
    # pin themselves to full f32 (ResNet's f32 forward missed this bound
    # at 1.813e-4 when they did not)
    pytorch_defaults()
    check(torch.backends.cudnn.allow_tf32,
          "the card-vs-CPU check runs under PyTorch's default flags")
    clip = BACKBONE_CPU_CLIPS[key]
    x = np.random.default_rng(SEED + 8).standard_normal(
        (1, *clip, 3), dtype=np.float32)
    got, took = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        got[device] = VideoServer(
            key, build_video_model(key, VIDEO_OUT, clip, seed=SEED),
            dtype="float32", device=device, batch=1)(x).cpu().numpy()
        took[device] = time.perf_counter() - t0
    err = float(np.abs(got["cuda"] - got["cpu"]).max())
    top = float(np.abs(got["cpu"]).max())
    print(f"{key} f32 card vs CPU at batch 1, clip {clip}, cuDNN's TF32 "
          f"flag at PyTorch's default (on): max abs err {err:.3e} "
          f"(tolerance {VIDEO_F32_SHARE} x {top:.4f} = "
          f"{VIDEO_F32_SHARE * top:.3e}); CPU {took['cpu']:.1f} s")
    check(err <= VIDEO_F32_SHARE * top, f"{key} card vs CPU err {err}")
    print(f"{key} serving phase: {time.perf_counter() - start:.1f} s")
    return peak


def int8_conv_launches(model, inputs):
    """The launches that one int8 forward must make, given each int8
    layer's input in ``inputs`` (``int8_inputs``): for a hooked Conv3d or
    Conv2d of C >= IMPLICIT_MIN_CHANNELS one implicit conv, after one
    prologue at k = 1 unless a w8 bf16 input is read as it is (contiguous,
    C a multiple of 8, 16-byte aligned); for a narrower one, one 3-D
    prologue and one product (s8 for w8a8, bf16 for w8) a chunk of whole
    samples whose columns fit in COLUMN_BUDGET; one prologue and one s8
    product for each w8a8 Linear."""
    from multi_modal_csi_tpu_torch.core.quantize import COLUMN_BUDGET
    from multi_modal_csi_tpu_torch.kernels.int8_matmul import (
        IMPLICIT_MIN_CHANNELS, conv3d_output, padded_width)
    from multi_modal_csi_tpu_torch.nn.layers import Conv2d, Conv3d, Linear
    counts = {}

    def add(name, n=1):
        counts[name] = counts.get(name, 0) + n
    for module in model.modules():
        if getattr(module, "weight", None) is None or (
                module.weight.dtype != torch.int8):
            continue
        w8a8 = hasattr(module, "input_scale")
        shape, dtype, direct = inputs[module]
        if isinstance(module, Linear):
            check(w8a8, "an int8 w8 Linear beside the convs")
            add(COLUMNS)
            add(S8)
            continue
        check(isinstance(module, (Conv2d, Conv3d)) and module.hooked,
              f"int8 {type(module).__name__} is not a hooked conv")
        if shape[-1] >= IMPLICIT_MIN_CHANNELS:
            if w8a8 or not direct:
                add(COLUMNS)
            add(CONV3D)
            continue
        if isinstance(module, Conv2d):
            shape = (shape[0], 1, *shape[1:])
            geometry = ((1, *module.weight.shape[2:]), (1, *module.stride),
                        (0, 0, 0))
        else:
            geometry = (tuple(module.weight.shape[2:]), module.stride,
                        module.padding)
        dims = conv3d_output(tuple(shape[1:4]), *geometry)
        col = torch.int8 if w8a8 else torch.bfloat16
        sample = (math.prod(dims) * col.itemsize
                  * padded_width(module.weight[0].numel(), col))
        chunks = -(-shape[0] // max(1, COLUMN_BUDGET // sample))
        add(COLUMNS3D, chunks)
        add(S8 if w8a8 else BF16, chunks)
    return counts


@contextlib.contextmanager
def int8_inputs(model):
    """module -> (shape, dtype, whether a w8 implicit conv reads it as it
    is) of each int8 layer's input in the block's forwards."""
    inputs = {}

    def keep(module, args):
        x = args[0]
        inputs[module] = (tuple(x.shape), x.dtype,
                          x.dtype == torch.bfloat16 and x.is_contiguous()
                          and x.shape[-1] % 8 == 0
                          and x.storage_offset() % 8 == 0)
    hooks = [m.register_forward_pre_hook(keep) for m in model.modules()
             if getattr(m, "weight", None) is not None
             and m.weight.dtype == torch.int8]
    try:
        yield inputs
    finally:
        for h in hooks:
            h.remove()


def stem_call(key):
    """Whether a ``captured_calls`` key is S3D's stem temporal (7, 1, 1)
    conv, an implicit conv of C = 64."""
    return key[0] == "conv3d" and key[4] == (7, 1, 1)


def backbone_int8_phase(key, bf16_peak):
    """``key`` (ResNet, S3D) served with --quant auto (w8a8) in bf16 at
    its serving batch, calibrated (amax) on BACKBONE_CALIB_CLIPS seeded
    clips: exact implicit-conv, P1 s8, 3-D prologue and 1-D prologue
    launches in one batch forward (``int8_conv_launches``), the prologues,
    the fused products and the implicit convs held against their plain
    versions at every call of a batch forward (timed at every ResNet call
    and at S3D's stem temporal conv, ``stem_call``), the ragged requests,
    the rates, serving's peak memory (after the checks) beside bf16's, a
    profile with the kernels' shares, the logits against bf16 serving
    (ResNet: the JAX package's 0.35 of the spread; S3D printed); at
    ResNet's layer1, the k = 1 prologue against its byte bound and the
    int8 conv against cuDNN's bf16 conv3d (another function: the
    yardstick w8a8 must beat); then the same int8 weights at f32 on the card
    against the CPU: the distance and the int8 codes that the devices' f32
    noise put on the other side of a rounding boundary, per layer, printed
    (they compound over the layers, each flip moving the next layer's
    input by a step); then the CPU fed the card's codes at every layer, so
    that each layer's codes see one layer's noise alone: at every layer
    the CPU's own codes within one step of the card's and differing in at
    most INT8_FLIP_SHARE of them, and the logits within VIDEO_F32_SHARE
    of the largest.
    Returns the main path's launch counts."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.serving import VideoServer
    from multi_modal_csi_tpu_torch.runners.video import (VIDEO_CLIPS,
                                                         build_video_model)
    start = time.perf_counter()
    pytorch_defaults()
    clip = VIDEO_CLIPS[key]
    calib = np.random.default_rng(SEED + 9).standard_normal(
        (BACKBONE_CALIB_CLIPS, *clip, 3), dtype=np.float32)
    requests = backbone_requests(key)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = VideoServer(key, build_video_model(key, VIDEO_OUT, seed=SEED),
                         device="cuda", quant="auto", calib=calib)
    torch.cuda.synchronize()
    int8 = [n for n, p in server.model.named_parameters()
            if p.dtype == torch.int8]
    label = f"{key} {server.quant}"
    print(f"{label}: {len(int8)} int8 weights, calibrated on {len(calib)} "
          f"clips in {time.perf_counter() - t0:.1f} s")
    check(server.quant == "w8a8" and server.dtype == torch.bfloat16,
          f"{key} --quant auto resolved {server.quant} {server.dtype}")
    server(requests[0][:server.batch])                        # warm-up
    torch.cuda.synchronize()
    batch = torch.from_numpy(requests[0][:server.batch]).cuda()
    kernels.reset_launch_counts()
    with int8_inputs(server.model) as inputs:
        server.forward(batch)
        torch.cuda.synchronize()
    one = dict(kernels.LAUNCH_COUNTS)
    want = int8_conv_launches(server.model, inputs)
    print(f"{label}: launches in one batch forward: {one}")
    check(one == want, f"{label} launched {one}, expected {want}")
    with captured_calls() as calls:
        server.forward(batch)
        torch.cuda.synchronize()
    timed = (lambda k: True) if key == "ResNet" else stem_call
    check(sum(map(timed, calls)) in (1, len(calls)),
          f"{label}: timed {[k for k in calls if timed(k)]}")
    FUSED_TOTALS[key] = check_fused(label, calls, timed)
    del calls
    # the peak of serving alone, without the calls check_fused held
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    outs, launches, host, rates = host_and_card_rates(label, server,
                                                      requests, 1)
    batches = sum(-(-len(r) // server.batch) for r in requests)
    check(launches == {n: c * batches for n, c in want.items()},
          f"{label} main path launched {launches}")
    bf16_host, bf16_card = SERVE_RATES[key]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: bf16 serving {bf16_host:.2f} clips/s from host memory, "
          + ", ".join(f"{r:.2f}" for r in bf16_card) + " on the card; peak "
          f"memory {peak:.2f} GiB (bf16 {bf16_peak:.2f} GiB)")
    prof = profile_device(label, lambda: server.forward(batch), 2,
                          "forward")
    int8_shares(label, prof)

    if key == "ResNet":
        # the int8 conv (the k = 1 prologue and the implicit conv) against
        # cuDNN's bf16 conv3d at layer1, and the prologue against its bound
        import torch.nn.functional as F
        from multi_modal_csi_tpu_torch.core.quantize import conv_codes
        conv = server.model.backbone.layer1[0].conv1[0]
        x = torch.randn(LAYER1_SHAPE, device="cuda", dtype=torch.bfloat16)
        w = torch.randn((64, 64, 3, 3, 3), device="cuda",
                        dtype=torch.bfloat16)
        xf = x.permute(0, 4, 1, 2, 3).contiguous()
        cudnn = cuda_ms(lambda: F.conv3d(xf, w, padding=1), 5, 1)
        port_bf16 = cuda_ms(lambda: F.conv3d(
            x.permute(0, 4, 1, 2, 3).contiguous(), w, padding=1), 5, 1)
        int8_ms = cuda_ms(lambda: conv(x), 5, 1)
        codes = conv_codes(x, conv.input_scale)
        codes_ms = cuda_ms(lambda: conv_codes(x, conv.input_scale), 5, 1)
        codes_bound = 1e3 * (x.numel() * 2 + codes.numel()) / PEAK_BYTES
        print(f"ResNet layer1 conv at {LAYER1_SHAPE} (3x3x3 -> 64): w8a8 "
              f"(the k = 1 prologue and the implicit conv, one launch "
              f"each) {int8_ms:.3f} ms; cuDNN bf16 conv3d, another "
              f"function, {cudnn:.3f} ms (with the port's channels-first "
              f"copy {port_bf16:.3f} ms); the prologue alone, bf16 to "
              f"{tuple(codes.shape)} int8 codes, {codes_ms:.3f} ms against "
              f"a byte bound of {codes_bound:.3f} ms "
              f"({100 * codes_bound / codes_ms:.1f}%)")
        del x, w, xf, codes

    got = outs[1].numpy()
    del server, batch
    torch.cuda.empty_cache()
    ref = VideoServer(key, build_video_model(key, VIDEO_OUT, seed=SEED),
                      device="cuda")(requests[1]).cpu().numpy()
    spread = float(np.abs(got - ref).max() / (ref.std() + 1e-9))
    bound = INT8_SPREAD_BOUND.get(key)
    print(f"{label} vs bf16 serving on {len(requests[1])} clips: max abs "
          f"diff {np.abs(got - ref).max():.4f} = {spread:.4f} of the bf16 "
          f"logits' spread ("
          + (f"bound {bound})" if bound else "the JAX package has no bound "
             "for it)"))
    check(bound is None or spread < bound, f"{label} vs bf16 {spread}")
    torch.cuda.empty_cache()

    # the same int8 weights and scales at f32, batch 2: the card against
    # the CPU, and against the CPU fed the card's int8 codes
    pytorch_defaults()
    small = INT8_BACKBONE_CPU_CLIPS[key]
    x = np.random.default_rng(SEED + 10).standard_normal(
        (2, *small, 3), dtype=np.float32)
    cpu = VideoServer(key, build_video_model(key, VIDEO_OUT, small,
                                             seed=SEED),
                      dtype="float32", device="cpu", batch=2, quant="w8a8",
                      calib=x)
    with recorded_activations() as cpu_codes:
        want_out = cpu(x).numpy()
    card = VideoServer(key, cpu.model, dtype="float32", device="cuda",
                       batch=2)
    kernels.reset_launch_counts()
    with recorded_activations() as card_codes, int8_inputs(
            card.model) as card_inputs:
        got_out = card(x).cpu().numpy()
    card_launches = dict(kernels.LAUNCH_COUNTS)
    with replayed_activations(card_codes) as own:
        replayed = VideoServer(key, card.model, dtype="float32", device="cpu",
                               batch=2)(x).numpy()
    check(len(card_codes) == len(cpu_codes) == len(own),
          f"{label}: {len(card_codes)} quantized layers on the card, "
          f"{len(cpu_codes)} and {len(own)} on the CPU")
    flips = [int((a != b).sum()) for a, b in zip(cpu_codes, card_codes)]
    layer_flips = [int((a != b).sum()) for a, b in zip(own, card_codes)]
    steps = max(int((a.int() - b.int()).abs().max())
                for a, b in zip(own, card_codes))
    shares = [f / a.numel() for f, a in zip(layer_flips, card_codes)]
    worst = max(range(len(shares)), key=shares.__getitem__)
    err = float(np.abs(got_out - want_out).max())
    err_replayed = float(np.abs(got_out - replayed).max())
    top = float(np.abs(want_out).max())
    print(f"{label} f32 card vs CPU at {small}, the same int8 weights: max "
          f"abs err {err:.3e} = {err / top:.3e} of the largest logit "
          f"{top:.4f} (printed; INT8_CPU_SHARE {INT8_CPU_SHARE} holds the "
          f"CSI models), the int8 codes differing in {sum(flips)} of "
          f"{sum(a.numel() for a in cpu_codes)} over {len(flips)} quantized "
          f"layers, per layer {flips}; card launches {card_launches}")
    print(f"{label} the CPU fed the card's codes: per layer its own codes "
          f"differ in {layer_flips} (by at most {steps} step), the largest "
          f"share {shares[worst]:.2e} at layer {worst} of "
          f"{card_codes[worst].numel()} codes (bound {INT8_FLIP_SHARE}); "
          f"logits {err_replayed:.3e} from the card's (tolerance "
          f"{VIDEO_F32_SHARE} x {top:.4f})")
    check(card_launches == int8_conv_launches(card.model, card_inputs)
          and card_launches.get(CONV3D, 0) > 0,
          f"{label} f32 card launched {card_launches}")
    check(steps <= 1 and shares[worst] <= INT8_FLIP_SHARE,
          f"{label}: with the card's codes in, the CPU's codes differ by "
          f"{steps} steps, in {shares[worst]:.2e} of them at layer {worst}")
    check(err_replayed <= VIDEO_F32_SHARE * top,
          f"{label} card vs CPU with the card's codes {err_replayed}")
    print(f"{label} serving phase: {time.perf_counter() - start:.1f} s")
    return launches


@contextlib.contextmanager
def replayed_activations(codes):
    """Inside the block the quantized layers' prologues (1-D and 3-D;
    the implicit conv's codes are the 1-D prologue's at k = 1) return
    ``codes`` in order (``recorded_activations``' CPU copies from another
    device's run of the same forward) in place of their own int8
    operands, so that a comparison measures the rest of the path. Yields
    the list of the operands that they made themselves (CPU copies)."""
    from multi_modal_csi_tpu_torch.core import quantize as Q
    real, real3d, own = Q.quantize_columns, Q.quantize_columns3d, []

    def replaying(fn):
        def quantize(x, scale, *args):
            q = fn(x, scale, *args)
            if scale is None:
                return q
            want = codes[len(own)].to(q.device)
            own.append(q.cpu())
            check(want.shape == q.shape, f"replayed codes {tuple(want.shape)} "
                                         f"for {tuple(q.shape)}")
            return want
        return quantize
    Q.quantize_columns, Q.quantize_columns3d = replaying(real), replaying(
        real3d)
    try:
        yield own
    finally:
        Q.quantize_columns, Q.quantize_columns3d = real, real3d
    check(len(own) == len(codes), f"replayed {len(own)} of {len(codes)} "
                                  f"int8 operands")


def backbone_train_phase(key):
    """One f32 training step of ``key`` at batch 2 at full width on the
    card (PyTorch's default TF32 settings, dropout as built): no hand
    kernel (exactly no launch), the peak memory, and for BACKBONES_TIMED
    clips trained per second and a profile of BACKBONE_PROFILED steps;
    then one step at
    BACKBONE_STEP_CLIPS with dropout and drop-path off on the card (TF32
    off), on the CPU in f32 and in float64, the CPU taking the card's ReLU
    sides and max-pool picks (``KinkReplay``): the loss within
    STEP_F32_TOL relative and the BatchNorm statistics within
    STATS_F32_TOL of the CPU's f32, each gradient within GRAD_F32_TOL of
    its scale of the CPU's f32, or else within GRAD_F64_RATIO times the
    CPU f32 step's own distance from float64 of the float64 step."""
    import copy

    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.device import cudnn_f32
    from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
    from multi_modal_csi_tpu_torch.runners.video import (VIDEO_CLIPS,
                                                         build_video_model)
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      make_train_step)
    start = time.perf_counter()
    pytorch_defaults()
    rng = np.random.default_rng(SEED + 11)
    clip = VIDEO_CLIPS[key]
    bx = torch.from_numpy(rng.standard_normal(
        (VIDEO_TRAIN_BATCH, *clip, 3), dtype=np.float32)).cuda()
    by = torch.from_numpy((rng.random((VIDEO_TRAIN_BATCH, VIDEO_OUT)) < 0.5)
                          .astype(np.float32)).cuda()
    torch.cuda.empty_cache()
    model = build_video_model(key, VIDEO_OUT, seed=SEED).cuda()
    step = make_train_step(model, adam_like_torch(model.parameters(), 1e-4),
                           bce_with_logits, augment=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step(bx, by, gen)                                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step(bx, by, gen)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{key} f32 training step at batch {VIDEO_TRAIN_BATCH}, clip "
          f"{clip}: launches {launches}; peak memory {peak:.2f} GiB")
    check(not launches, f"{key} training step launched {launches}")
    if key in BACKBONES_TIMED:
        train_rate(f"{key} f32 training", step, bx, by, gen, unit="clips")
        profile_device(f"{key} f32 training", lambda: step(bx, by, gen),
                       BACKBONE_PROFILED, "step")
    del model, step, bx, by
    torch.cuda.empty_cache()

    pytorch_defaults()
    small = BACKBONE_STEP_CLIPS[key]
    x = rng.standard_normal((VIDEO_TRAIN_BATCH, *small, 3),
                            dtype=np.float32)
    y = (rng.random((VIDEO_TRAIN_BATCH, VIDEO_OUT)) < 0.5).astype(
        np.float32)
    base = without_dropout(build_video_model(key, VIDEO_OUT, small,
                                             seed=SEED)).train()
    kinks, got = KinkReplay(key), {}
    for run, device, dtype in (("card", "cuda", torch.float32),
                               ("cpu", "cpu", torch.float32),
                               ("f64", "cpu", torch.float64)):
        model = copy.deepcopy(base).to(device=device, dtype=dtype)
        with kinks.on(device):
            loss = bce_with_logits(
                model(torch.from_numpy(x).to(device, dtype)),
                torch.from_numpy(y).to(device, dtype))
            with cudnn_f32():              # as the port's training steps
                loss.backward()
        if run == "cpu":
            replayed = kinks.report()
        got[run] = (float(loss), {n: p.grad.detach().cpu().double()
                                  for n, p in model.named_parameters()},
                    {n: b.detach().cpu().double()
                     for n, b in model.named_buffers()
                     if n.endswith(("running_mean", "running_var"))})
        del model
    (card_loss, card, card_stats), (cpu_loss, cpu, cpu_stats) = (
        got["card"], got["cpu"])
    exact = got["f64"][1]
    floor = 1e-2 * max(g.abs().max().item() for g in exact.values())

    def distance(a, b):
        return max(((a[n] - b[n]).abs().max().item()
                    / max(b[n].abs().max().item(), floor), n) for n in b)

    worst = distance(card, cpu)
    card_f64, cpu_f64 = distance(card, exact), distance(cpu, exact)
    stats = max(((((card_stats[n] - cpu_stats[n]).abs().max().item()
                   / cpu_stats[n].abs().max().item()), n)
                 for n in cpu_stats), default=(0.0, "none"))
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"{key} f32 training step at {small}, card vs CPU: {replayed}; "
          f"loss {card_loss:.6f} vs {cpu_loss:.6f} (relative {rel:.2e}, tolerance "
          f"{STEP_F32_TOL}); worst gradient {worst[0]:.2e} of its scale in "
          f"{worst[1]} (tolerance {GRAD_F32_TOL}); from float64 the card "
          f"{card_f64[0]:.2e} ({card_f64[1]}), the CPU {cpu_f64[0]:.2e} "
          f"({cpu_f64[1]}); worst BatchNorm statistic {stats[0]:.2e} of its "
          f"largest in {stats[1]} (tolerance {STATS_F32_TOL})")
    check(rel <= STEP_F32_TOL, f"{key} card vs CPU step loss {rel}")
    check(worst[0] <= GRAD_F32_TOL
          or card_f64[0] <= GRAD_F64_RATIO * cpu_f64[0],
          f"{key} card vs CPU gradient {worst}, from float64 {card_f64} "
          f"(the CPU's {cpu_f64})")
    check(stats[0] <= STATS_F32_TOL, f"{key} card vs CPU statistic {stats}")
    print(f"{key} training phase: {time.perf_counter() - start:.1f} s")


def run_video_default_phase(clips, annotation, work):
    """cli/run_video.py with no --model (the default, Swin-T, as the JAX
    CLI's) on the card: RUN_CLIPS cached clips, identity task, repeat 1,
    one epoch at batch 2, the final test pass in Swin's serving dtype
    (f32); the result JSON read back with the JAX runner's keys; no hand
    kernel runs (exactly no launch)."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.cli import run_video
    pytorch_defaults()
    save = os.path.join(work, "results", "default-run_video.json")
    kernels.reset_launch_counts()
    start = time.perf_counter()
    result = run_video.main([
        "--repeat", "1", "--set", f"path.video_pre_x={clips}",
        "--set", f"path.data_y={annotation}", "--set", f"path.save={save}",
        "--set", "nn.epoch=1", "--set", f"nn.batch_size={VIDEO_TRAIN_BATCH}",
        "--set", "compute_dtype=auto"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = dict(kernels.LAUNCH_COUNTS)
    with open(save) as f:
        written = json.load(f)
    print(f"run_video default model {written['model']}: {wall:.2f} s wall, "
          f"fit {result['time_train']['avg']:.2f} s, final test pass "
          f"{result['time_test']['avg']:.3f} s; accuracy "
          f"{result['accuracy']['avg']:.3f}, parameters "
          f"{result['complexity']['parameter']}; launches {launches}")
    check(written["model"] == "Swin-T", f"run_video's default model is "
                                        f"{written['model']}")
    check(set(written) == VIDEO_RESULT_KEYS
          and "micro avg" in written["repeat_0"]
          and all(math.isfinite(written[k]["avg"]) for k in
                  ("accuracy", "time_train", "time_test")),
          f"Swin-T result JSON {sorted(written)}")
    check(not launches, f"Swin-T run launched {launches}")


# the export phase: card-only artifacts (``--platforms cuda``) of four
# serving paths, each against its eager server on the same weights and
# inputs; then Swin-T f32 against the CPU and a ``cuda,cpu`` MLP w8, the
# CLI's default platforms
EXPORT_SHARE = 1e-5        # artifact vs eager server, of the largest logit
SWIN_EXPORT_SHARE = 2e-6   # Swin-T f32 artifact vs the CPU, of the largest
SWIN_EXPORT_CLIP = (16, 224, 224)   # batch 1, as the backbone's CPU check
EXPORT_PROFILED = 2        # forwards timed by the profiler, each side
EXPORT_WINDOWS = 256       # the CSI artifacts' batch (the serving batch)
EXPORT_GRAPH_BYTES = 2 ** 25   # an artifact's bytes beside its weights
# the MLP w8 cuda,cpu artifact, card vs CPU, of the largest logit: w8 rounds
# layer_0's output to bf16 for layer_1, and the card's f32 sum over K =
# 810,000 in another order flips some of those roundings (3.17e-4 with the
# plain versions on both sides, H100 80GB HBM3 at 700 W)
MLP_EXPORT_CPU_SHARE = 2e-3


def mmcsi_ops(blob):
    """The ``mmcsi`` custom ops in an artifact's graph, with counts, read
    from the program archive's graph JSON (deserializing a program takes
    seconds)."""
    import io
    import re
    import zipfile
    ops = {}
    with zipfile.ZipFile(io.BytesIO(blob)) as archive:
        graphs = [n for n in archive.namelist()
                  if "/models/" in n and n.endswith(".json")]
        check(bool(graphs), "the artifact's archive holds no graph")
        for name in graphs:
            for op in re.findall(r'"target": "torch\.ops\.mmcsi\.(\w+)\.',
                                 archive.read(name).decode()):
                ops[op] = ops.get(op, 0) + 1
    return ops


def unique_bytes(model):
    """Bytes of a model's parameters and buffers, each storage once."""
    storages = {}
    for t in (*model.parameters(), *model.buffers()):
        storage = t.untyped_storage()
        storages[storage.data_ptr()] = storage.nbytes()
    return sum(storages.values())


def export_case(label, server, build, x, work, *, dtype, quant=None,
                calib=None):
    """A card-only artifact of ``build()`` (the server's model, on the
    same seeded weights) exported with ``core/export.py``, saved, reloaded
    with ``serve_file`` and run on ``x``: the same launches as one eager
    forward of ``server``, its logits within EXPORT_SHARE of the eager
    server's largest; export, load and device times beside the eager
    server's. Returns the artifact forward's launches."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.export import (
        export_serving, save_artifact, serve_file, stored_bytes)
    xb = torch.from_numpy(x).cuda()
    server.forward(xb)                                        # warm-up
    kernels.reset_launch_counts()
    want = server.forward(xb)
    torch.cuda.synchronize()
    eager = dict(kernels.LAUNCH_COUNTS)
    start = time.perf_counter()
    blob = export_serving(build().cuda(), torch.empty(x.shape),
                          serving_dtype=dtype, quant=quant,
                          calib_x=None if calib is None else [calib],
                          platforms=("cuda",))
    export_s = time.perf_counter() - start
    path = os.path.join(work, f"{label.replace(' ', '_')}.mmcsi")
    save_artifact(path, blob, {"model": label, "batch": len(x),
                               "serving_dtype": dtype, "quant": quant,
                               "platforms": ["cuda"]})
    start = time.perf_counter()
    fn, _ = serve_file(path)
    load_s = time.perf_counter() - start
    fn(xb)                                                    # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = fn(xb)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCH_COUNTS)
    ops = mmcsi_ops(blob)
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    stored, held = stored_bytes(blob), unique_bytes(server.model)
    art_ms = device_ms(lambda: fn(xb), EXPORT_PROFILED)
    eager_ms = device_ms(lambda: server.forward(xb), EXPORT_PROFILED)
    print(f"export {label}: {export_s:.1f} s to export, {len(blob) / 1e6:.1f}"
          f" MB ({stored / 1e6:.1f} MB of weight files; the eager server "
          f"holds {held / 1e6:.1f} MB), "
          f"{load_s:.2f} s to load; graph ops {ops}; launches a forward "
          f"{launches} (eager {eager}); logits vs eager max abs err "
          f"{err:.3e} (tolerance {EXPORT_SHARE} x {top:.4f}); device ms a "
          f"forward {art_ms:.3f} (eager {eager_ms:.3f})")
    check(launches == eager and launches and ops,
          f"{label} artifact launched {launches}, eager {eager}")
    check(tuple(got.shape) == tuple(want.shape)
          and got.dtype == torch.float32,
          f"{label} artifact output {tuple(got.shape)} {got.dtype}")
    check(err <= EXPORT_SHARE * top, f"{label} artifact vs eager {err}")
    # each weight stored once (an int8 one as its padded copy, which the
    # eager server holds beside it; a float program may add a few small
    # constants its forward makes), and beyond the weights only the graph
    check(stored < (held if quant else held + 2 ** 20),
          f"{label}: {stored} bytes of weight files, the server {held}")
    check(len(blob) - stored < EXPORT_GRAPH_BYTES,
          f"{label}: {len(blob) - stored} bytes beside the weight files")
    return launches


def export_phase(work, calib_path):
    """Serving artifacts (core/export.py, ROADMAP item 13b) on the card:
    card-only artifacts of THAT bf16 at 256 windows (K1), DETR w8a8 at 256
    (P1 and the prologue), MViT-v2 bf16 at 2 clips (K3) and ResNet w8a8 at
    8 clips (the implicit conv, the 3-D prologue and P1), each as
    ``export_case`` checks it;
    a Swin-T f32 card-only artifact at batch 1, loaded and run with cuDNN's
    TF32 flag at PyTorch's default (on), against the CPU's f32 forward
    within SWIN_EXPORT_SHARE of the largest logit; a ``cuda,cpu`` MLP w8
    artifact with the input BatchNorm folded and the int8 input contract:
    its ``mmcsi`` ops launch the prologue and P1 on the card as often as
    the eager w8 server of the same weights, its logits within
    EXPORT_SHARE of that server's, and the same artifact on the CPU within
    MLP_EXPORT_CPU_SHARE; layer_0's f32 row, too wide for the prologue's
    shared window, held bit for bit against the plain version first.
    Returns the launches of the artifacts' checked forwards, summed."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.export import (export_serving,
                                                       load_serving)
    from multi_modal_csi_tpu_torch.core.serving import CSIServer, VideoServer
    from multi_modal_csi_tpu_torch.models.csi.mlp import MLP, fold_input_norm
    from multi_modal_csi_tpu_torch.runners.csi import build_model
    from multi_modal_csi_tpu_torch.runners.video import (VIDEO_CLIPS,
                                                         build_video_model)
    start = time.perf_counter()
    pytorch_defaults()
    rng = np.random.default_rng(SEED + 12)
    windows = rng.standard_normal((EXPORT_WINDOWS, LENGTH, CHANNELS),
                                  dtype=np.float32)
    calib = np.load(calib_path)
    totals = {}

    def add(launches):
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n

    cases = [
        ("THAT bf16", "THAT", CSIServer, windows, "bfloat16", None, None),
        ("DETR w8a8", "DETR", CSIServer, windows, "bfloat16", "w8a8", calib),
        ("MViT-v2 bf16", "MViT-v2", VideoServer,
         rng.standard_normal((2, *VIDEO_CLIPS["MViT-v2"], 3),
                             dtype=np.float32), "bfloat16", None, None)]
    resnet_clips = rng.standard_normal(
        (BACKBONE_CALIB_CLIPS, *VIDEO_CLIPS["ResNet"], 3), dtype=np.float32)
    cases.append(("ResNet w8a8", "ResNet", VideoServer, resnet_clips,
                  "bfloat16", "w8a8", resnet_clips))
    for label, key, make, x, dtype, quant, cal in cases:
        if make is CSIServer:
            def build(key=key):
                return build_model(key, seed=SEED)
        else:
            def build(key=key):
                return build_video_model(key, VIDEO_OUT, seed=SEED)
        server = make(key, build(), batch=len(x), dtype=dtype,
                      device="cuda", quant=quant, calib=cal)
        add(export_case(label, server, build, x, work, dtype=dtype,
                        quant=quant, calib=cal))
        del server
        torch.cuda.empty_cache()

    # Swin-T f32, card-only, under PyTorch's default flags (cuDNN's TF32
    # on): the artifact's convs run in full f32 all the same
    x = rng.standard_normal((1, *SWIN_EXPORT_CLIP, 3), dtype=np.float32)
    model = build_video_model("Swin-T", VIDEO_OUT, SWIN_EXPORT_CLIP,
                              seed=SEED)
    with torch.no_grad():
        cpu = model(torch.from_numpy(x)).numpy()
    blob = export_serving(model.cuda(), x, platforms=("cuda",))
    fn = load_serving(blob)
    check(torch.backends.cudnn.allow_tf32,
          "the Swin-T artifact runs under PyTorch's default flags")
    card = fn(x).cpu().numpy()
    check(torch.backends.cudnn.allow_tf32,
          "the artifact's call restores the caller's TF32 flag")
    err = float(np.abs(card - cpu).max())
    top = float(np.abs(cpu).max())
    print(f"export Swin-T f32 (card only, cuDNN's TF32 flag at PyTorch's "
          f"default) at (1, {SWIN_EXPORT_CLIP}) vs the CPU: max abs err "
          f"{err:.3e} = {err / top:.2e} of the largest logit (tolerance "
          f"{SWIN_EXPORT_SHARE}); graph ops {mmcsi_ops(blob)}")
    check(err <= SWIN_EXPORT_SHARE * top, f"Swin-T artifact vs CPU {err}")
    del model, fn, blob

    # MLP w8 for cuda and the CPU (the CLI's default platforms): the hand
    # kernels as ops, which launch on the card and take their plain
    # versions on the CPU; the input BatchNorm folded into layer_0, int8
    # windows dequantized in the program
    features = LENGTH * CHANNELS
    model = build_model("MLP", seed=SEED)
    folded = MLP(54, in_features=features, fold_input_norm=True,
                 generator=torch.Generator().manual_seed(SEED))
    folded.load_state_dict(fold_input_norm(model.state_dict()))
    flat = calib.reshape(len(calib), features)
    scale = max(float(np.abs(flat).max()), 1e-12) / 127.0
    x8 = np.clip(np.round(windows.reshape(len(windows), features) / scale),
                 -127, 127).astype(np.int8)
    x8b = torch.from_numpy(x8).cuda()
    # the eager w8 server of the same folded weights, fed the artifact's
    # own dequantization of the int8 windows
    server = CSIServer("MLP", copy.deepcopy(folded), batch=len(x8),
                       dtype="float32", device="cuda", quant="w8",
                       calib=flat)
    xf = x8b.float() * torch.tensor(scale, dtype=torch.float32,
                                    device="cuda")
    # the f32 activation's bf16 columns for layer_0: a row of 810,000
    # values, too wide for the prologue's shared window, so written
    # straight from x; bit-equal to the plain version
    from multi_modal_csi_tpu_torch.kernels.int8_matmul import (
        quantize_columns, quantize_columns_reference)
    rows = xf[None]
    cols = quantize_columns(rows, None)
    plain = quantize_columns_reference(rows, None)
    col_err = float((cols.float() - plain.float()).abs().max())
    col_ms = cuda_ms(lambda: quantize_columns(rows, None))
    plain_ms = cuda_ms(lambda: quantize_columns_reference(rows, None))
    bound = (rows.numel() * 4 + cols.numel() * 2) / PEAK_BYTES * 1e3
    print(f"prologue, direct (no shared window), f32 {tuple(rows.shape)} to "
          f"bf16 columns {tuple(cols.shape)}: max abs err vs plain "
          f"{col_err:.3e}; kernel {col_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound bytes {bound:.4f} ms")
    check(cols.shape == plain.shape and col_err == 0.0,
          f"direct prologue vs plain {col_err}")
    del rows, cols, plain
    server.forward(xf)                                        # warm-up
    kernels.reset_launch_counts()
    want = server.forward(xf)
    torch.cuda.synchronize()
    eager = dict(kernels.LAUNCH_COUNTS)
    t0 = time.perf_counter()
    blob = export_serving(folded.eval().cuda(), x8, input_dtype="int8",
                          input_scale=scale, quant="w8", calib_x=[flat],
                          platforms=("cuda", "cpu"))
    export_s = time.perf_counter() - t0
    ops = mmcsi_ops(blob)
    fn = load_serving(blob)
    fn(x8b)                                                   # warm-up
    kernels.reset_launch_counts()
    card = fn(x8b)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCH_COUNTS)
    card_ms = device_ms(lambda: fn(x8b), EXPORT_PROFILED)
    eager_ms = device_ms(lambda: server.forward(xf), EXPORT_PROFILED)
    add(launches)
    eager_err = float((card - want).abs().max())
    eager_top = float(want.abs().max())
    cpu = load_serving(blob, "cpu")(x8)
    err = float((card.cpu() - cpu).abs().max())
    top = float(cpu.abs().max())
    print(f"export MLP w8, folded, int8 input, cuda,cpu: {export_s:.1f} s "
          f"to export, {len(blob) / 1e6:.1f} MB; graph ops {ops}; launches "
          f"a forward {launches} (eager {eager}); logits vs eager max abs "
          f"err {eager_err:.3e} (tolerance {EXPORT_SHARE} x "
          f"{eager_top:.4f}); device ms a forward {card_ms:.3f} (eager "
          f"{eager_ms:.3f}); card vs CPU max abs err {err:.3e} = "
          f"{err / top:.2e} of the largest logit (tolerance "
          f"{MLP_EXPORT_CPU_SHARE})")
    check(ops and launches and launches == eager,
          f"MLP cuda,cpu artifact: ops {ops}, launches {launches}, eager "
          f"{eager}")
    check(tuple(card.shape) == (len(windows), 54)
          and bool(torch.isfinite(card).all()),
          f"MLP artifact output {tuple(card.shape)}")
    check(eager_err <= EXPORT_SHARE * eager_top,
          f"MLP artifact vs eager {eager_err}")
    check(err <= MLP_EXPORT_CPU_SHARE * top,
          f"MLP artifact card vs CPU {err}")
    print(f"export phase: {time.perf_counter() - start:.1f} s")
    return totals


def columns3d_entry(launches):
    """The JSON description of the 3-D prologue: its times and bound
    summed over one ResNet3D-18 w8a8 forward at its serving batch of 64
    (45, 112, 112) clips, from ``check_fused``. No one PyTorch call
    computes the quantization with the 3-D unfold (library null). It
    replaces no TPU kernel of its own: it is the activation quantization
    and the conv windows that XLA fuses into P1's product in the JAX
    package's int8 conv (core/quantize.py:174)."""
    total = FUSED_TOTALS["ResNet"]["columns3d"]
    bytes_ms, ops_ms = total["bytes_ms"], total["ops_ms"]
    return {
        "name": COLUMNS3D, "route": "cuda",
        "source": "multi_modal_csi_tpu_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "multi_modal_csi_tpu/core/quantize.py:174",
        "launches": launches, "max_abs_err": total["err"],
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def conv3d_entry(launches):
    """The JSON description of the implicit conv, P1's product kernel
    with the conv window read by its A loader: its times and bound summed
    over one ResNet3D-18 w8a8 forward at its serving batch of 64 (45, 112,
    112) clips, from ``check_fused``. No one PyTorch call computes an int8
    conv3d (library null; cuDNN's bf16 conv3d at layer1, another function,
    is printed beside it). It is P1's s8 body (tools/exp_pallas_int8.py:43)
    on the windows that XLA fuses into the JAX package's int8 conv."""
    total = FUSED_TOTALS["ResNet"]["conv3d"]
    bytes_ms, ops_ms = total["bytes_ms"], total["ops_ms"]
    return {
        "name": CONV3D, "route": "cuda",
        "source": "multi_modal_csi_tpu_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "tools/exp_pallas_int8.py:43",
        "launches": launches, "max_abs_err": total["err"],
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


# the parallel phase: the data-parallel layer at world
# size 1 through a real NCCL group, each wrapped run against the plain run
# from the same seed
PARALLEL_TRAIN = 64        # THAT_ENCODER windows: 3 steps at TRAIN_BATCH
PARALLEL_VALID = 16        # one validation chunk
PARALLEL_CLIPS = (4, 2)    # MViT-v2 training and test clips: 2 steps at
                           # VIDEO_TRAIN_BATCH
PARALLEL_NCE = (256, 256)  # InfoNCE rows and width (SSL's projection)
PARALLEL_PROFILED = 2      # steps profiled after the profiler's warm-up
# a wrapped run's losses against the plain run's, relative: at world size
# 1 the wrapped run does the plain run's arithmetic (the all-reduce and
# FSDP2's gather and reduce-scatter over one rank copy), so the expected
# difference is 0, and f32 rounding at most
PARALLEL_REL = 1e-5
# a wrapped step's gradients against the plain step's, relative to each
# plain tensor's largest: f32 sums in another order
PARALLEL_GRAD_REL = 1e-4
RING_SHAPE = (16, 10, 150, 27)   # THAT's time tokens, (B, H, N, D)
RING_TOL = 1e-5
K3_F32_MARKS = ("attention_f32_kernel",)
K4_MARKS = {"dQ/dR": ("attention_bwd_dq_lowrank",),
            "dK/dV/dS": ("attention_bwd_dkv",)}


def settle(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def kernels_named(kernels, marks):
    return sum(n for name, n in kernels.items()
               if any(mark in name for mark in marks))


def nccl_kernels(kernels):
    return {name[:60]: n for name, n in kernels.items()
            if "nccl" in name.lower()}


def largest_rel(history, plain, keys):
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
               for a, b in zip(history, plain) for k in keys)


def step_profile(fn, marks):
    """``fn()`` under torch.profiler, one warm-up call and then
    PARALLEL_PROFILED counted calls (the profiler's schedule: a window that
    opened on the call lost kernel records, one K1 of five and one conv in
    a THAT_ENCODER step). Returns per call the device ms, each hand
    kernel's launches (``marks``: name -> kernel-name marks), the NCCL
    kernels and the collectives the host issued (``nccl:*`` and
    ``c10d::*`` operations)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1,
                                   active=PARALLEL_PROFILED,
                                   repeat=1)) as prof:
        for _ in range(1 + PARALLEL_PROFILED):
            fn()
            torch.cuda.synchronize()
            prof.step()
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    device_us = sum(e.self_device_time_total for e in device)
    check(device_us > 0, "a parallel-phase profile holds no device time")
    launches = {e.key: e.count / PARALLEL_PROFILED for e in device}
    host = {e.key: e.count / PARALLEL_PROFILED for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.key.startswith(("nccl:", "c10d::"))}
    return (device_us / 1e3 / PARALLEL_PROFILED,
            {name: kernels_named(launches, m) for name, m in marks.items()},
            nccl_kernels(launches), host)


def profiled_steps(label, steps, bx, by, marks, device):
    """Profile the steps of each way (plain first) at ``bx``
    (``step_profile``): device ms beside the plain step's, the hand
    kernels' launches, the NCCL kernels and collectives; each way must
    launch the plain step's hand kernels."""
    ms, counted = {}, {}
    for way, step in steps.items():
        gen = torch.Generator(device=device).manual_seed(SEED)
        ms[way], counted[way], nccl, host = step_profile(
            lambda: step(bx, by, gen), marks)
        print(f"{label} {way} step: {ms[way]:.3f} device ms (plain "
              f"{ms['plain']:.3f}; {card_line()}); hand kernels a step "
              f"{counted[way]}; NCCL kernels {nccl}; collectives issued "
              f"{host}")
        check(all(counted[way].values()), f"{label} {way} step ran no "
                                          f"{counted[way]}")
        check(counted[way] == counted["plain"],
              f"{label} {way} step launched {counted[way]}, the plain step "
              f"{counted['plain']}")


def parallel_that(sharding, device):
    """THAT_ENCODER at full width: ``fit`` for one epoch (3 steps at
    TRAIN_BATCH, one validation chunk) plain, with ``sharding`` (the
    gradient all-reduce), with ``sharding`` and ``fsdp``, and with
    ``sharding`` and the tensor-parallel rules applied (K1/K2 on the
    rank's heads), from one seed, dropout and augmentation on: each
    wrapped run's losses within PARALLEL_REL of the plain run's and its
    launches the plain run's; then one step of each way profiled. Returns
    the wrapped runs' launches."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.parallel.partition import (
        apply_tensor_parallel)
    from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS, build_model
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch, fit,
                                                      make_train_step)
    cfg = Config().override({"data.length": LENGTH})
    spec = CSI_MODELS["THAT_ENCODER"]
    loss_fn = spec.make_loss(cfg, 10)
    rng = np.random.default_rng(SEED + 11)

    def windows(n):
        x = rng.standard_normal((n, LENGTH, CHANNELS), dtype=np.float32)
        return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, (n, 5))]

    (x_tr, y_tr), (x_va, y_va) = windows(PARALLEL_TRAIN), windows(
        PARALLEL_VALID)
    settings = dict(loss_fn=loss_fn, mode=spec.mode, lr=cfg.nn.lr, epochs=1,
                    batch_size=TRAIN_BATCH, seed=SEED,
                    weight_decay=spec.weight_decay,
                    threshold=cfg.nn.threshold, batch_axis=spec.batch_axis,
                    device=device)
    ways = {"plain": {}, "sharded": {"sharding": sharding},
            "fsdp": {"sharding": sharding, "fsdp": True},
            "tensor-parallel": {"sharding": sharding}}
    start = build_model("THAT_ENCODER", seed=SEED, cfg=cfg)
    runs, wrapped = {}, {}
    for way, kwargs in ways.items():
        model = copy.deepcopy(start)
        if way == "tensor-parallel":
            apply_tensor_parallel(model.to(device), sharding.mesh)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fit(model, x_tr, y_tr, x_va, y_va, **settings, **kwargs)
        settle(device)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCH_COUNTS)
        runs[way] = (res, launches, model)
        h = res.history[0]
        print(f"THAT_ENCODER fit {way}: train loss {h['train_loss']!r}, "
              f"validation loss {h['test_loss']!r}, {wall:.2f} s wall; "
              f"launches {launches}")
        check(math.isfinite(h["train_loss"]) and math.isfinite(
            h["test_loss"]), f"THAT_ENCODER fit {way}: loss not finite")
        if way == "plain":
            continue
        wrapped[way] = launches
        rel = largest_rel(res.history, runs["plain"][0].history,
                          ("train_loss", "test_loss"))
        weights = max((res.best_state[k].float()
                       - runs["plain"][0].best_state[k].float()).abs().max()
                      .item() for k in res.best_state)
        print(f"THAT_ENCODER fit {way} against plain: largest relative loss "
              f"difference {rel:.3e} (bound {PARALLEL_REL:g}), largest "
              f"best-weight difference {weights:.3e}")
        check(rel <= PARALLEL_REL, f"THAT_ENCODER fit {way}: losses "
                                   f"{rel:.3e} from the plain run's")
        check(res.best_state.keys() == runs["plain"][0].best_state.keys(),
              f"THAT_ENCODER fit {way}: the best weights' keys")
        check(launches == runs["plain"][1]
              and launches.get("flash_attention_f32", 0) > 0
              and launches.get("flash_attention_backward", 0) > 0,
              f"THAT_ENCODER fit {way} launched {launches}, the plain run "
              f"{runs['plain'][1]}")
    bx = torch.from_numpy(x_tr[:TRAIN_BATCH]).to(device)
    by = torch.from_numpy(y_tr[:TRAIN_BATCH]).to(device)
    steps = {way: make_train_step(
        runs[way][2], adam_like_torch(runs[way][2].parameters(), cfg.nn.lr,
                                      spec.weight_decay), loss_fn, **kwargs)
             for way, kwargs in ways.items()}
    profiled_steps("THAT_ENCODER", steps, bx, by,
                   {"K1": (K1_F32,),
                    "K2": tuple(K2_PASSES[torch.float32].values())}, device)
    return wrapped


def parallel_mvit(sharding, device):
    """MViT-v2 at its clip: ``fit_video`` for one epoch (2 steps at
    VIDEO_TRAIN_BATCH, f32) plain, with ``sharding`` and ``fsdp``, and with
    ``sharding`` and the tensor-parallel rules applied (K3/K4 on the
    rank's heads), from one seed: each wrapped run's loss within
    PARALLEL_REL of the plain run's, the accuracies equal, the same
    launches; then one step of each profiled. Returns the wrapped runs'
    launches."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.data.video_io import ArrayClips
    from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
    from multi_modal_csi_tpu_torch.parallel.partition import (
        apply_tensor_parallel)
    from multi_modal_csi_tpu_torch.runners.video import (build_video_model,
                                                         fit_video)
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      make_train_step)
    rng = np.random.default_rng(SEED + 12)
    n_tr, n_te = PARALLEL_CLIPS
    x = rng.standard_normal((n_tr + n_te, *VIDEO_CLIP, 3), dtype=np.float32)
    y = (rng.random((n_tr + n_te, VIDEO_OUT)) < 0.5).astype(np.float32)
    train, test = ArrayClips(x[:n_tr], y[:n_tr]), ArrayClips(x[n_tr:],
                                                              y[n_tr:])
    ways = {"plain": {}, "fsdp": {"sharding": sharding, "fsdp": True},
            "tensor-parallel": {"sharding": sharding}}
    start = build_video_model("MViT-v2", VIDEO_OUT, VIDEO_CLIP, seed=SEED)
    runs, wrapped = {}, {}
    for way, kwargs in ways.items():
        model, history = copy.deepcopy(start), []
        if way == "tensor-parallel":
            apply_tensor_parallel(model.to(device), sharding.mesh)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _, acc = fit_video(model, train, test, lr=1e-4, epochs=1,
                           batch_size=VIDEO_TRAIN_BATCH, seed=SEED,
                           threshold=0.5, verbose=False, num_workers=2,
                           history=history, device=device, **kwargs)
        settle(device)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCH_COUNTS)
        runs[way] = (history, launches, model)
        print(f"MViT-v2 fit_video {way}: {history[0]}, best accuracy {acc}, "
              f"{wall:.2f} s wall; launches {launches}")
        if way == "plain":
            continue
        wrapped[way] = launches
        plain_history, plain_launches, _ = runs["plain"]
        rel = largest_rel(history, plain_history, ("train_loss",))
        print(f"MViT-v2 fit_video {way} against plain: relative loss "
              f"difference {rel:.3e} (bound {PARALLEL_REL:g})")
        check(rel <= PARALLEL_REL, f"MViT-v2 fit_video {way}: loss "
                                   f"{rel:.3e} from the plain run's")
        check(all(a[k] == b[k] for a, b in zip(history, plain_history)
                  for k in ("train_acc", "test_acc")),
              f"MViT-v2 fit_video {way}: accuracies differ from the plain "
              f"run's")
        check(launches == plain_launches and launches.get(K3, 0) > 0
              and launches.get(DQ, 0) > 0 and launches.get(DKV, 0) > 0,
              f"MViT-v2 fit_video {way} launched {launches}, the plain run "
              f"{plain_launches}")
    bx = torch.from_numpy(x[:VIDEO_TRAIN_BATCH]).to(device)
    by = torch.from_numpy(y[:VIDEO_TRAIN_BATCH]).to(device)
    steps = {way: make_train_step(
        runs[way][2], adam_like_torch(runs[way][2].parameters(), 1e-4),
        bce_with_logits, augment=False, **kwargs)
             for way, kwargs in ways.items()}
    profiled_steps("MViT-v2", steps, bx, by,
                   dict(K3=K3_F32_MARKS, **{f"K4 {part}": marks for part,
                                             marks in K4_MARKS.items()}),
                   device)
    return wrapped


def parallel_detr(sharding, device):
    """DETR at ``entry``'s shape, (8, 3000, 270) windows (``entry.py``):
    two training steps as ``dryrun_multichip`` takes them (augmentation,
    dropout, the Hungarian loss, ``adam_like_torch(5e-4, 2e-4)``) plain
    and with the tensor-parallel rules applied over ``sharding``'s mesh,
    from one seed: both losses within PARALLEL_REL of the plain steps'
    (the second one after the first update) and the first step's
    gradients within PARALLEL_GRAD_REL of each plain tensor's largest
    (and at least a hundredth of the largest of all)."""
    from multi_modal_csi_tpu_torch.entry import entry
    from multi_modal_csi_tpu_torch.losses.matching import (
        HungarianMatchingLoss)
    from multi_modal_csi_tpu_torch.parallel.partition import (
        apply_tensor_parallel, full_tensor)
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      make_train_step)
    forward, (x,) = entry(device)
    rng = np.random.default_rng(SEED + 14)
    bx = torch.from_numpy(rng.standard_normal(
        tuple(x.shape), dtype=np.float32)).to(device)
    by = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, (x.shape[0], 5))]).to(device)
    got = {}
    for way, kwargs in (("plain", {}),
                        ("tensor-parallel", {"sharding": sharding})):
        model = copy.deepcopy(forward.model)
        if kwargs:
            apply_tensor_parallel(model.to(device), sharding.mesh)
        step = make_train_step(
            model, adam_like_torch(model.parameters(), 5e-4, 2e-4),
            HungarianMatchingLoss(), augment=True, **kwargs)
        gen = torch.Generator(device=device).manual_seed(SEED)
        t0 = time.perf_counter()
        losses = [step(bx, by, gen)[0].item()]
        grads = {name: full_tensor(p.grad).clone()
                 for name, p in model.named_parameters()}
        losses.append(step(bx, by, gen)[0].item())
        settle(device)
        wall = time.perf_counter() - t0
        got[way] = (losses, grads)
        print(f"DETR {tuple(bx.shape)} training steps {way}: losses "
              f"{losses!r}, {wall:.2f} s wall for both ({card_line()})")
        check(all(map(math.isfinite, losses)), f"DETR steps {way}: loss "
                                              f"not finite")
    (plain, before), (sharded, after) = got["plain"], got["tensor-parallel"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(sharded, plain))
    check(before.keys() == after.keys(), "DETR steps: the parameters differ")
    floor = 1e-2 * max(g.abs().max().item() for g in before.values())
    grad_rel, worst = max(
        ((after[k] - g).abs().max().item() / max(g.abs().max().item(), floor),
         k) for k, g in before.items())
    print(f"DETR tensor-parallel steps against plain: largest relative loss "
          f"difference {rel:.3e} (bound {PARALLEL_REL:g}); first step's "
          f"gradients {grad_rel:.3e} of their tensor's largest, in {worst} "
          f"(bound {PARALLEL_GRAD_REL:g})")
    check(rel <= PARALLEL_REL, f"DETR tensor-parallel steps: losses "
                               f"{rel:.3e} from the plain steps'")
    check(grad_rel <= PARALLEL_GRAD_REL, f"DETR tensor-parallel step: "
                                         f"gradients {grad_rel:.3e} from "
                                         f"the plain step's in {worst}")


def parallel_ring(mesh, device):
    """Ring attention (``kernels/ring_attention.py``) over the mesh's data
    axis of one rank at THAT's time-token shape, (16, 10, 150, 27) f32,
    against ``full_attention_reference``: error under RING_TOL; both
    timed."""
    from multi_modal_csi_tpu_torch.kernels.ring_attention import (
        full_attention_reference, ring_attention)
    from multi_modal_csi_tpu_torch.parallel.collectives import axis_scope
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    q, k, v = (torch.randn(RING_SHAPE, generator=gen, device=device)
               for _ in range(3))
    with axis_scope(mesh):
        out = ring_attention(q, k, v, "data")
        ring_ms = cuda_ms(lambda: ring_attention(q, k, v, "data"))
    ref = full_attention_reference(q, k, v)
    err = (out - ref).abs().max().item()
    full_ms = cuda_ms(lambda: full_attention_reference(q, k, v))
    print(f"ring attention {RING_SHAPE} f32 over a data axis of 1: error "
          f"{err:.3e} against full attention (bound {RING_TOL:g}); "
          f"{ring_ms:.4f} ms, full attention {full_ms:.4f} ms "
          f"({card_line()})")
    check(err < RING_TOL, f"ring attention error {err:.3e}")


def parallel_info_nce(mesh, device):
    """SSL's InfoNCE with the gather over the mesh's data axis (NCCL
    all-gather, its backward a reduce-scatter) against the plain loss:
    the loss and both gradients within PARALLEL_REL."""
    from multi_modal_csi_tpu_torch.models.csi.ssl import info_nce
    from multi_modal_csi_tpu_torch.parallel.collectives import axis_scope
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    z = [torch.randn(PARALLEL_NCE, generator=gen, device=device,
                     requires_grad=True) for _ in range(2)]
    plain = info_nce(*z)
    plain_grads = torch.autograd.grad(plain, z)
    with axis_scope(mesh):
        gathered = info_nce(*z, gather_axis="data")
        grads = torch.autograd.grad(gathered, z)
        _, _, nccl, host = step_profile(
            lambda: torch.autograd.grad(info_nce(*z, gather_axis="data"), z),
            {})
    rel = abs(gathered.item() - plain.item()) / abs(plain.item())
    grad_rel = max(((g - p).abs().max() / p.abs().max()).item()
                   for g, p in zip(grads, plain_grads))
    print(f"info_nce with the gather: {gathered.item()!r} against the plain "
          f"{plain.item()!r} (relative {rel:.3e}), gradients {grad_rel:.3e} "
          f"of their largest; NCCL kernels {nccl}, collectives issued "
          f"{host}")
    check(rel <= PARALLEL_REL and grad_rel <= PARALLEL_REL,
          "info_nce with the gather differs from the plain loss")


def parallel_phase(device="cuda"):
    """The parallel layer on the card at world size 1: a real NCCL group
    joined as torchrun describes one (``one_rank_group``: a free local
    port), a ("data", "model") = (1, 1) mesh over
    it, THAT_ENCODER's ``fit`` plain, with the gradient all-reduce, with
    FSDP2 and with the tensor-parallel rules (``parallel_that``),
    MViT-v2's ``fit_video`` plain, with FSDP2 and with the rules
    (``parallel_mvit``), DETR's step at ``entry``'s shape plain and with
    the rules (``parallel_detr``), ring attention (``parallel_ring``),
    InfoNCE with the gather (``parallel_info_nce``) and
    ``dryrun_multichip(1)`` in the same group, which prints its line; the
    group is destroyed at the end. Returns the wrapped runs' launches:
    THAT_ENCODER's (sharded, fsdp, tensor-parallel), MViT-v2's (fsdp,
    tensor-parallel)."""
    import torch.distributed as dist
    from multi_modal_csi_tpu_torch.entry import dryrun_multichip
    from multi_modal_csi_tpu_torch.parallel.mesh import (batch_sharding,
                                                         create_mesh,
                                                         one_rank_group)
    pytorch_defaults()
    start = time.perf_counter()
    with one_rank_group(device):
        backend = dist.get_backend()
        check(backend == ("nccl" if device == "cuda" else "gloo"),
              f"the parallel phase's group runs {backend}")
        mesh = create_mesh()
        sharding = batch_sharding(mesh)
        print(f"parallel phase: a {backend} group of "
              f"{dist.get_world_size()} rank, mesh {mesh}, batch split "
              f"{sharding.size} ways")
        def timed(name, part, *args):
            t0 = time.perf_counter()
            out = part(*args, device)
            print(f"parallel phase: {name} {time.perf_counter() - t0:.1f} s "
                  f"({card_line()})")
            return out

        that = timed("THAT_ENCODER", parallel_that, sharding)
        mvit = timed("MViT-v2", parallel_mvit, sharding)
        timed("DETR", parallel_detr, sharding)
        timed("ring attention", parallel_ring, mesh)
        timed("InfoNCE", parallel_info_nce, mesh)
        timed("dryrun_multichip(1)", lambda device: dryrun_multichip(
            1, device))
    print(f"parallel phase: {card_line()}; "
          f"{time.perf_counter() - start:.1f} s")
    return list(that.values()), list(mvit.values())


RUN_START = time.perf_counter()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from multi_modal_csi_tpu_torch.kernels.csi_preprocess import (
        amplitude_phase, amplitude_phase_reference)
    from multi_modal_csi_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward,
        flash_attention_backward_reference, flash_attention_reference)
    from multi_modal_csi_tpu_torch.kernels.flash_attention_lowrank import (
        flash_attention_lowrank_bias, flash_attention_lowrank_bias_backward,
        flash_attention_lowrank_bias_backward_reference,
        flash_attention_lowrank_bias_reference)

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    build_kernels()

    fwd_times = phase_kernel(flash_attention, flash_attention_reference)
    bwd_times = phase_backward(flash_attention_backward,
                               flash_attention_backward_reference)
    k5_times = phase_k5(amplitude_phase, amplitude_phase_reference)
    k3_times = phase_lowrank(flash_attention_lowrank_bias,
                             flash_attention_lowrank_bias_reference)
    k4_times = phase_lowrank_backward(
        flash_attention_lowrank_bias, flash_attention_lowrank_bias_backward,
        flash_attention_lowrank_bias_backward_reference)
    phase_p1()
    phase_fits()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        preprocessed, converted_amp = preprocess_phase(work)

        rng = np.random.default_rng(SEED)
        requests = [rng.standard_normal((n, LENGTH, CHANNELS),
                                        dtype=np.float32) for n in REQUESTS]
        that = serve_phase("THAT", requests, lambda n: (n, 54), 5)
        detr = serve_phase("DETR", requests, lambda n: (6, n, 5, 10), 0)
        check("flash_attention" not in detr,
              "DETR launched the attention kernel")
        encoder = serve_phase("THAT_ENCODER", requests,
                              lambda n: (7, n, 5, 10), 5)
        # the WiMANS baselines: no kernel in bf16 serving
        start = time.perf_counter()
        for key in BASELINES:
            serve_phase(key, requests, lambda n: (n, 54), 0,
                        served=1 if key in STEP_LOOPS else None)
        calib = os.path.join(work, "calib.npy")
        np.save(calib, np.random.default_rng(SEED + 3).standard_normal(
            (CALIB_WINDOWS, LENGTH, CHANNELS), dtype=np.float32))
        int8_runs = [
            int8_serve_phase("MLP", requests, calib, {}, MLP_BF16, 0,
                             lambda n: (n, 54), 0, mode="w8"),
            int8_serve_phase("CNN-1D", requests, calib, CNN1D_S8, {},
                             CNN1D_COLUMNS, lambda n: (n, 54), 0,
                             quant="w8a8"),
            # CNN-2D's int8 Conv2d: stages 1 and 2 on the implicit conv
            int8_serve_phase("CNN-2D", requests, calib, {}, {}, None,
                             lambda n: (n, 54), 0, quant="w8", mode="w8"),
            int8_serve_phase("CNN-2D", requests, calib, {}, {}, None,
                             lambda n: (n, 54), 0, quant="w8a8")]
        baseline_s = time.perf_counter() - start
        int8_runs += [
            int8_serve_phase("DETR", requests, calib, DETR_S8, DETR_BF16,
                             DETR_COLUMNS, lambda n: (6, n, 5, 10), 0),
            int8_serve_phase("THAT_ENCODER", requests, calib, ENCODER_S8,
                             ENCODER_BF16, ENCODER_COLUMNS,
                             lambda n: (7, n, 5, 10), 5),
            int8_cli_phase(calib)]
        p1_totals("THAT_ENCODER w8a8", ENCODER_S8, torch.int8)
        p1_totals("THAT_ENCODER w8a8", ENCODER_BF16, torch.bfloat16)
        p1_totals("MLP w8", MLP_BF16, torch.bfloat16)
        p1_totals("CNN-1D w8a8", CNN1D_S8, torch.int8)
        encoder_int8 = int8_runs[3]
        del requests

        data = training_data()
        trained, trained_bf16_that = train_phase_that(data)
        train_step_card_vs_cpu("THAT", data[0][:2], data[1][:2])
        train_phase_detr(data)
        start = time.perf_counter()
        for key in BASELINES:
            train_phase_baseline(key, data)
        for key in ("LSTM", "CNN-2D"):
            train_step_card_vs_cpu(key, data[0][:2], data[1][:2])
        baseline_s += time.perf_counter() - start

        start = time.perf_counter()
        with cudnn_deterministic():      # launcher_phase's reference runs
            experiment = run_csi_phase(work, converted_amp)
        print(f"run_experiment phase (THAT_ENCODER, DETR, MLP, CNN-1D): "
              f"{time.perf_counter() - start:.1f} s")
        launcher_phase(work)
        ops_phase(work)
        print("WiMANS baselines: serving (bf16, int8), training and the "
              f"card-vs-CPU steps took {baseline_s:.1f} s of wall time")
        # checkpoints, transfer, resume and the last three CSI keys
        start = time.perf_counter()
        transfer = transfer_phase(work)
        resumed = resume_phase(data, work)
        ssl_phase(data, work)
        dual_band_phase(data)
        strf_phase(data)
        print(f"checkpoint, transfer, resume, SSL, dual band and ST-RF "
              f"phases: {time.perf_counter() - start:.1f} s of wall time")
        del data

        clips = video_requests()
        served = [video_serve_phase(key, clips) for key in
                  ("MViT-v1", "MViT-v2")]
        video_int8 = video_int8_phase(clips)
        int8_runs.append(video_int8)
        del clips
        # ResNet3D-18, S3D, Swin3D-T and Swin3D-S: served in their dtype
        # at their batch, ResNet and S3D in w8a8, one training step each
        start = time.perf_counter()
        peaks = {key: backbone_serve_phase(key) for key in BACKBONES}
        int8_runs += [backbone_int8_phase(key, peaks[key])
                      for key in INT8_BACKBONES]
        for key in BACKBONES:
            backbone_train_phase(key)
        backbones_s = time.perf_counter() - start
        video = [runs for runs, _ in served] + [video_int8]
        card_vs_cpu = [video_card_vs_cpu(key) for key in
                       ("MViT-v1", "MViT-v2")]
        video += card_vs_cpu
        video += [video_evaluate_phase(work, key) for key in
                  ("MViT-v1", "MViT-v2")]
        # the training paths, each of which launches K3 and K4 (in bf16
        # the serving phases' training steps, MViT-v2's bf16 step and the
        # bf16 run_video run)
        steps_f32 = [video_train_phase(key) for key in
                     ("MViT-v1", "MViT-v2")]
        steps_f32.append(video_train_card_vs_cpu())
        step_bf16 = video_train_phase("MViT-v2", torch.bfloat16)
        clip_dir, annotation = write_video_run(work)
        experiments = [
            run_video_phase(clip_dir, annotation, work, "MViT-v1",
                            save_model=os.path.join(work, "mvit_v1.pt")),
            run_video_phase(clip_dir, annotation, work, "MViT-v2"),
            run_video_phase(clip_dir, annotation, work, "MViT-v2",
                            "bfloat16")]
        start = time.perf_counter()
        run_video_default_phase(clip_dir, annotation, work)
        backbones_s += time.perf_counter() - start
        print(f"ResNet, S3D, Swin-T and Swin-S phases (serving, int8, "
              f"training, run_video's default): {backbones_s:.1f} s of wall "
              f"time")
        # serving artifacts: K1 (THAT), P1, both prologues and the
        # implicit conv (DETR and ResNet in w8a8) and K3 (MViT-v2) inside
        # exported programs
        exported = export_phase(work, calib)
        int8_runs.append(exported)
        # the data-parallel layer: K1 and K2 (THAT_ENCODER), K3 and K4
        # (MViT-v2) inside the gradient all-reduce and FSDP2
        parallel_that_runs, parallel_mvit_runs = parallel_phase()
        trained_f32 = steps_f32 + [runs for runs, _ in experiments[:2]]
        trained_bf16 = ([step for _, step in served] + [step_bf16]
                        + [experiments[2][0]])
        video += trained_bf16 + trained_f32
        # K3's launches in f32: the f32 card-vs-CPU forwards, the f32
        # training steps and the f32 part of the run_video runs
        k3_f32 = (sum(runs[K3] for runs in card_vs_cpu + steps_f32)
                  + sum(n for _, n in experiments))

    # K1 bf16: per THAT forward (serving, batch 256); K1 f32 and K2: per
    # THAT training step of the dtype (batch 16); 4 left-stream and 1
    # right-stream launches each; launches summed over every main path
    # that ran them (each kernel's two dtypes are counted apart; K2 bf16's
    # main path is the bf16 fit epoch; K1 and K2 f32 also count the
    # THAT_ENCODER feature_encoder run, both resume fits and the parallel
    # phase's wrapped THAT_ENCODER fits, K1 bf16 that run's test pass). K5:
    # per WiMANS trace (3000, 270). K3 in bf16: per MViT-v2 forward
    # (batch 2, the bias on), its 16 launches; launches summed over the
    # video serving, evaluate and bf16 training runs of both variants and
    # run_video's bf16 test passes. K3 in f32: per MViT-v2 f32 training
    # step (batch 2, blocks 0-2 with the bias), its 3 launches; launches
    # k3_f32 and the parallel phase's FSDP2 and tensor-parallel fit_video.
    # K4's two kernels in each dtype: per MViT-v2 training step of the
    # dtype (batch 2), 3 each; launches summed over the dtype's training
    # runs (f32: fit_video, the card-vs-CPU step, two run_video runs and
    # the parallel phase's FSDP2 and tensor-parallel fit_video;
    # bf16: the serving phases' steps, the profiled bf16 step and one
    # run_video run). P1's two instantiations: per DETR w8a8 forward (bf16
    # serving, batch 256), 22 s8 and 54 bf16 products, as bare products
    # (as the TPU kernels compute them; the main path runs them fused);
    # launches summed over the int8 serving
    # runs (MLP w8, CNN-1D, DETR and THAT_ENCODER w8a8, the serve_csi CLI,
    # MViT-v2 w8). The
    # prologue: per DETR w8a8 forward, its 52 calls; launches likewise.
    # The 3-D prologue and the implicit conv: per ResNet w8a8 forward
    # (batch 64), over every int8 serving run. K1 bf16, K3 bf16, P1, both
    # prologues and the implicit conv also count the checked forward of
    # each card-only artifact of the export phase.
    trace = k5_times["trace"]
    k5_bytes, k5_ops = trace["bytes_ms"], trace["ops_ms"]
    print(f"chip_smoke: the whole run took "
          f"{time.perf_counter() - RUN_START:.1f} s of wall time")
    print(json.dumps({"kernels": [
        kernel_entry("flash_attention", "flash_attention.cu",
                     "multi_modal_csi_tpu/kernels/flash_attention.py:108",
                     sum(runs.get("flash_attention", 0) for runs in
                         (that, trained, trained_bf16_that, encoder,
                          experiment, encoder_int8, transfer, exported)),
                     fwd_times,
                     {"that-left": 4, "that-right": 1}, torch.bfloat16),
        # the f32 instantiation, the f32 body of tc_attention.cuh; its C
        # entry is in flash_attention.cu; times are device times
        kernel_entry("flash_attention_f32", "tc_attention.cuh",
                     "multi_modal_csi_tpu/kernels/flash_attention.py:108",
                     sum(runs.get("flash_attention_f32", 0) for runs in
                         (trained, experiment, transfer, resumed,
                          *parallel_that_runs)),
                     fwd_times,
                     {"that-left-16": 4, "that-right-16": 1},
                     torch.float32, as_3xtf32=True),
        # each instantiation's two kernels (the query pass and dK/dV),
        # all of tc_attention_bwd.cuh; the C entry is in
        # flash_attention_bwd.cu
        kernel_entry("flash_attention_backward", "tc_attention_bwd.cuh",
                     "multi_modal_csi_tpu/kernels/flash_attention.py:271",
                     sum(runs["flash_attention_backward"] for runs in
                         (trained, experiment, transfer, resumed,
                          *parallel_that_runs)),
                     bwd_times,
                     {"that-left-16": 4, "that-right-16": 1},
                     torch.float32, as_3xtf32=True),
        kernel_entry("flash_attention_backward_bf16", "tc_attention_bwd.cuh",
                     "multi_modal_csi_tpu/kernels/flash_attention.py:271",
                     trained_bf16_that["flash_attention_backward_bf16"],
                     bwd_times, {"that-left-16": 4, "that-right-16": 1},
                     torch.bfloat16),
        {"name": "csi_amplitude_phase", "route": "cuda",
         "source": "multi_modal_csi_tpu_torch/kernels/csrc/"
                   "csi_preprocess.cu",
         "replaces": "multi_modal_csi_tpu/kernels/csi_preprocess.py:44",
         "launches": preprocessed["csi_amplitude_phase"],
         "max_abs_err": max(r["err"] for r in k5_times.values()),
         "ms": trace["ms"], "plain_ms": trace["plain_ms"],
         "bound_ms": max(k5_bytes, k5_ops),
         "bound_by": "bytes" if k5_bytes >= k5_ops else "operations",
         "library_ms": trace["library_ms"]},
        kernel_entry("flash_attention_lowrank_bias",
                     "flash_attention_lowrank.cu",
                     "multi_modal_csi_tpu/kernels/flash_attention.py:377",
                     sum(runs[K3] for runs in video) - k3_f32
                     + exported.get(K3, 0), k3_times,
                     {f"{name}+bias": n
                      for name, (_, n) in LOWRANK_SHAPES.items()},
                     torch.bfloat16),
        kernel_entry("flash_attention_lowrank_bias_f32",
                     "flash_attention_lowrank.cu",
                     "multi_modal_csi_tpu/kernels/flash_attention.py:377",
                     k3_f32 + sum(runs[K3] for runs in parallel_mvit_runs),
                     k3_times,
                     {f"{name}+bias": 1 for name in LOWRANK_BWD_SHAPES},
                     torch.float32, as_3xtf32=True),
        # every body of both dtypes (the query pass with the bias, and
        # dK/dV/dS) is tc_attention_bwd.cuh's; every C entry is in
        # flash_attention_lowrank_bwd.cu
        k4_entry(DQ, "tc_attention_bwd.cuh",
                 "multi_modal_csi_tpu/kernels/flash_attention.py:480",
                 sum(runs[DQ] for runs in trained_f32 + parallel_mvit_runs),
                 k4_times, "dq", torch.float32),
        k4_entry(DKV, "tc_attention_bwd.cuh",
                 "multi_modal_csi_tpu/kernels/flash_attention.py:492",
                 sum(runs[DKV] for runs in trained_f32 + parallel_mvit_runs),
                 k4_times, "dkv", torch.float32),
        k4_entry(f"{DQ}_bf16", "tc_attention_bwd.cuh",
                 "multi_modal_csi_tpu/kernels/flash_attention.py:480",
                 sum(runs[DQ] for runs in trained_bf16), k4_times, "dq",
                 torch.bfloat16),
        k4_entry(f"{DKV}_bf16", "tc_attention_bwd.cuh",
                 "multi_modal_csi_tpu/kernels/flash_attention.py:492",
                 sum(runs[DKV] for runs in trained_bf16), k4_times, "dkv",
                 torch.bfloat16),
        p1_entry(S8, "tools/exp_pallas_int8.py:43",
                 sum(runs.get(S8, 0) for runs in int8_runs), DETR_S8,
                 torch.int8),
        p1_entry(BF16, "tools/exp_pallas_int8.py:48",
                 sum(runs.get(BF16, 0) for runs in int8_runs), DETR_BF16,
                 torch.bfloat16),
        columns_entry(sum(runs.get(COLUMNS, 0) for runs in int8_runs)),
        columns3d_entry(sum(runs.get(COLUMNS3D, 0) for runs in int8_runs)),
        conv3d_entry(sum(runs.get(CONV3D, 0) for runs in int8_runs)),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
