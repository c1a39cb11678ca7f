#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (multi_modal_csi_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit, torch and CUDA versions; build the
   four kernels (attention forward K1, its backward K2, the CSI
   amplitude-phase pass K5 and MViT's low-rank-bias attention K3) from
   csrc/ with one nvcc each, started together, timed, with nvcc's
   register and spill lines;
2. K1 against its plain PyTorch version on the card, f32 and bf16, at
   THAT's left (256, 150, 10, 27) and right (256, 270, 10, 15) shapes,
   THAT_ENCODER's right (256, 270, 10, 27), a ragged (3, 64, 10, 15) case
   and a cross case (Nq 128, Nk 420, 6 heads of 45); then per-launch times
   with CUDA events in the order plain, kernel, kernel, plain, beside
   scaled_dot_product_attention's time on the same inputs (a yardstick the
   port never calls) and the card's bound for the same work; a K and V too
   large for shared memory must raise;
3. K2 against its plain version, f32 and bf16, at THAT's and
   THAT_ENCODER's training shapes at batch 16 (and THAT's at 256), a
   ragged (3, 70, 10, 15) case with 97 keys and a cross case
   (4, 128, 6, 45) with 300 keys; per-launch times as for K1, beside the
   backward of scaled_dot_product_attention on the same inputs and the
   bound; a Q, dO, K and V too large for shared memory must raise;
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
   summed per MViT-v1 and v2 forward; a head dim of 160 must be refused;
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
   device time per forward, the device's busy share and the kernels with
   the most device time; then the same weights at f32 (TF32 off, batch 4)
   against the CPU, where the plain versions run; the same for DETR at
   the flagship configuration, with no kernel launch, and for
   THAT_ENCODER, with 5 K1 launches per forward;
7. THAT training at full width through ``fit``: seeded (80, 3000, 270)
   training and (32, 3000, 270) validation windows, activity labels,
   batch 16, 2 epochs, augmentation on, f32; exactly 5 K1 and 5 K2
   launches in one training step; windows trained per second after a
   warm-up step; 5 steps under torch.profiler; then one bf16 epoch;
8. one f32 THAT training step on the card against the CPU (TF32 off,
   batch 2, augmentation and dropout off, the CPU taking the card's side
   at every leaky-ReLU kink): loss and gradients;
9. DETR's training step at the flagship configuration, batch 16, with the
   Hungarian matching loss and augmentation: finite loss, no kernel
   launch, windows/s;
10. the experiment path (runners/csi.py::run_experiment) for THAT_ENCODER
   and DETR at full width: a synthetic annotation.csv of 48 windows in one
   environment, an amplitude cache of the 4 traces of phase 5 and 44
   windows of 2500 to 3000 steps, 2 epochs at batch 16, the final test
   pass in bf16; the result JSON read back with the JAX runner's keys;
   THAT_ENCODER's exact K1 and K2 launch counts, none for DETR;
11. MViT-v1 and MViT-v2 serving at full width (runners/video.py,
   core/serving.py::VideoServer), bf16, batch 2: seeded weights, ragged
   requests of 2, 1 and 3 seeded (45, 224, 224, 3) clips, exactly 16 K3
   launches per batch forward; clips/s from host memory and with the
   clips on the card; 5 forwards under torch.profiler; a training forward
   at the flash-backward gate must raise NotImplementedError;
12. each variant in f32 at (2, 16, 112, 112, 3) on the card (TF32 off,
   14 K3 launches) against the CPU, where K3's plain version runs, within
   1e-4 of the largest logit;
13. runners/video.py::evaluate for each variant over a ClipDataset of 5
   seeded cached clips, bf16, chunks of 2, the weights loaded with
   load_video_pretrained from a torchvision-layout .pt the script writes
   at (16, 224, 224): logits against VideoServer's, exactly 48 K3
   launches;
14. the bound of each TPU kernel still to port, worked out from a shape
   its path runs; one JSON line describing each ported kernel, then the
   card's name and power limit, then the result line.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


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
    rate for the dtype. The bound is the larger of the two."""
    b, nq, h, d = shape
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * nq * h * d + 2 * b * nk * h * d) * item
    flops = 4.0 * b * h * nq * nk * d
    return 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_FLOPS[dtype]


def phase_kernel(flash_attention, flash_attention_reference):
    """K1 against its plain version; times at the main path's shapes."""
    import torch.nn.functional as F
    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for name, (shape, nk) in KERNEL_SHAPES.items():
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
            if not name.startswith("that"):
                continue
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            plain = [cuda_ms(lambda: flash_attention_reference(q, k, v))]
            kern = [cuda_ms(lambda: flash_attention(q, k, v))
                    for _ in range(2)]
            plain.append(cuda_ms(lambda: flash_attention_reference(q, k, v)))
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            bytes_ms, ops_ms = attention_bound(shape, nk, dtype)
            results[(name, dtype)] = dict(
                err=err, ms=sum(kern) / 2, plain_ms=sum(plain) / 2,
                library_ms=lib, bytes_ms=bytes_ms, ops_ms=ops_ms)
            print(f"K1 {name} {dtype} per launch: kernel {kern[0]:.4f}/"
                  f"{kern[1]:.4f} ms, plain {plain[0]:.4f}/{plain[1]:.4f} ms,"
                  f" sdpa {lib:.4f} ms; bound: bytes {1e3 * bytes_ms:.1f} us,"
                  f" operations {1e3 * ops_ms:.1f} us")

    # K and V of one (b, h) beyond the block's shared memory: refused
    q = torch.zeros((1, 64, 1, 27), device="cuda")
    kv = torch.zeros((1, 4096, 1, 27), device="cuda")
    try:
        flash_attention(q, kv, kv)
        refused = False
    except ValueError as e:
        print(f"K1 Nk=4096 D=27: refused ({e})")
        refused = True
    check(refused, "K1 launched with K and V beyond shared memory")
    return results


def backward_bound(shape, nk, dtype):
    """The least times (ms) one attention backward needs on an H100 SXM:
    q, k, v and dO read once and dQ, dK, dV written once over the HBM
    rate, and the five products (QK^T and dO V^T recomputed, dQ, dK, dV:
    10 * B*H*Nq*Nk*D operations) over the peak rate for the dtype."""
    b, nq, h, d = shape
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (3 * b * nq * h * d + 4 * b * nk * h * d) * item
    flops = 10.0 * b * h * nq * nk * d
    return 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_FLOPS[dtype]


def phase_backward(backward, backward_reference):
    """K2 against its plain version; times at the training shapes."""
    import torch.nn.functional as F
    set_tf32(False)
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
            bytes_ms, ops_ms = backward_bound(shape, nk, dtype)
            results[(name, dtype)] = dict(
                err=max(errs), ms=sum(kern) / 2, plain_ms=sum(plain) / 2,
                library_ms=lib, bytes_ms=bytes_ms, ops_ms=ops_ms)
            print(f"K2 {name} {dtype} per launch: kernel {kern[0]:.4f}/"
                  f"{kern[1]:.4f} ms, plain {plain[0]:.4f}/{plain[1]:.4f} ms,"
                  f" sdpa backward {lib:.4f} ms; bound: bytes "
                  f"{1e3 * bytes_ms:.1f} us, operations {1e3 * ops_ms:.1f} us")

    # Q, dO, K and V of one (b, h) beyond the block's shared memory
    q = torch.zeros((1, 64, 1, 27), device="cuda")
    kv = torch.zeros((1, 4096, 1, 27), device="cuda")
    try:
        backward(q, kv, kv, q)
        refused = False
    except ValueError as e:
        print(f"K2 Nk=4096 D=27: refused ({e})")
        refused = True
    check(refused, "K2 launched beyond shared memory")
    return results


def ulps(got, want):
    """|got - want| in units in the last place of |want| (float32)."""
    w = want.float().abs()
    ulp = torch.nextafter(w, torch.full_like(w, math.inf)) - w
    return (got.float() - want.float()).abs() / ulp


def device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of ``fn``: the CUDA kernels' own time
    from torch.profiler over ``reps`` calls, after one untimed call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
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
    kernels with the most device time."""
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


def serve_phase(key, requests, expect_out, launches_per_forward):
    """Serve ``requests`` (host arrays) with ``key`` in bf16 at batch 256;
    then hold the same weights at f32 on the card against the CPU."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.serving import CSIServer
    from multi_modal_csi_tpu_torch.runners.csi import build_model

    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's own defaults
    server = CSIServer(key, build_model(key, seed=SEED), dtype="bfloat16",
                       device="cuda")
    server(requests[0][:server.batch])                        # warm-up
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    server.forward(torch.from_numpy(requests[0][:server.batch]))
    torch.cuda.synchronize()
    one = kernels.LAUNCH_COUNTS.get("flash_attention", 0)
    print(f"{key}: K1 launches in one batch forward: {one}")
    check(one == launches_per_forward,
          f"{key} launched K1 {one} times in one forward, "
          f"expected {launches_per_forward}")

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
          f"from host memory, {n} windows in {batches} batch forwards; with "
          f"the requests already on the card, {RESIDENT_ROUNDS} timings: "
          + ", ".join(f"{r:.1f}" for r in rates) + " windows/s")
    batch = resident[0][:server.batch]
    profile_device(key, lambda: server.forward(batch), PROFILED_FORWARDS,
                   "forward")
    del resident

    # f32 on the card (TF32 off) against the CPU, where the plain
    # versions run, on the same seeded weights and 4 windows
    set_tf32(False)
    x = requests[1][:4]
    card = CSIServer(key, build_model(key, seed=SEED), dtype="float32",
                     device="cuda", batch=4)(x).cpu().numpy()
    cpu = CSIServer(key, build_model(key, seed=SEED), dtype="float32",
                    device="cpu", batch=4)(x).numpy()
    err = float(np.abs(card - cpu).max())
    print(f"{key} f32 card vs CPU: max abs err {err:.3e} "
          f"(tolerance {SERVE_F32_TOL} abs + rel)")
    check(np.allclose(card, cpu, atol=SERVE_F32_TOL, rtol=SERVE_F32_TOL),
          f"{key} f32 card vs CPU err {err}")
    return launches


def without_dropout(model):
    """p = 0 on every dropout of a port model (layers and attention)."""
    from multi_modal_csi_tpu_torch.nn.layers import (Dropout,
                                                     MultiheadAttention)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
        elif isinstance(m, MultiheadAttention):
            m.dropout = 0.0
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


def train_rate(label, step, bx, by, gen):
    """Windows trained per second over TRAIN_RATE_STEPS steps, after the
    caller's warm-up step."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(TRAIN_RATE_STEPS):
        loss, _ = step(bx, by, gen)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    rate = TRAIN_RATE_STEPS * bx.shape[0] / elapsed
    print(f"{label}: {rate:.1f} windows trained/s at batch {bx.shape[0]} "
          f"({TRAIN_RATE_STEPS} steps in {elapsed * 1e3:.1f} ms, the "
          f"batch already on the card), last loss {float(loss):.4f}")
    check(math.isfinite(float(loss)), f"{label}: loss not finite")
    return rate


def train_phase_that(data):
    """THAT training: one counted step, its rate and profile, then the main
    path (fit, 2 f32 epochs) and one bf16 epoch. Returns the main path's
    launch counts."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS, build_model
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch, fit,
                                                      make_train_step)
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's own defaults
    cfg, spec = Config(), CSI_MODELS["THAT"]
    loss_fn = spec.make_loss(cfg, 54)
    x_tr, y_tr, x_va, y_va = data
    settings = dict(loss_fn=loss_fn, mode=spec.mode, lr=cfg.nn.lr,
                    batch_size=TRAIN_BATCH, seed=SEED,
                    weight_decay=spec.weight_decay,
                    threshold=cfg.nn.threshold, patience=cfg.nn.patience,
                    batch_axis=spec.batch_axis, augment=True)

    model = build_model("THAT", seed=SEED).cuda()
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
    one = dict(kernels.LAUNCH_COUNTS)
    print(f"THAT training: launches in one step: {one}")
    check(one == {"flash_attention": 5, "flash_attention_backward": 5},
          f"THAT training step launched {one}, expected 5 K1 and 5 K2")
    train_rate("THAT f32 training", step, bx, by, gen)
    profile_device("THAT f32 training", lambda: step(bx, by, gen),
                   PROFILED_STEPS, "step")
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
    want = {"flash_attention": 5 * steps + 5 * 2,
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
    check(bf16.get("flash_attention_backward") == 5 * steps // 2,
          f"THAT bf16 fit launched {bf16}")
    return launches


def train_step_card_vs_cpu(data):
    """One f32 THAT step at batch 2 on the card (TF32 off) and on the CPU,
    from the same seeded weights and batch, augmentation and dropout off:
    the loss within STEP_F32_TOL relative, each gradient within
    GRAD_F32_TOL of its tensor's scale.

    The scale is the tensor's largest CPU gradient, floored at 1e-2 of the
    model's largest: a conv bias feeding a training BatchNorm, or a
    LayerNorm bias feeding only such convs, has a zero gradient in exact
    arithmetic and float noise on both devices.

    The devices round differently, so a pre-activation within rounding of
    zero can land on the other side of a leaky ReLU's kink, where the
    slope is 0.01 instead of 1; through the BatchNorm before it, one such
    element moves whole gradient tensors by percents. So the card's step
    records the side of every leaky-ReLU input, the CPU step takes the
    card's side at each (and counts where its own differs), and the
    comparison measures rounding alone."""
    import torch.nn.functional as F
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.models.csi import that as that_module
    from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS, build_model
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      make_train_step)
    set_tf32(False)
    cfg, spec = Config(), CSI_MODELS["THAT"]
    x, y = data[0][:2], data[1][:2]
    sides, flips = [], [0, 0]

    def recording(v):
        sides.append(v > 0)
        return F.leaky_relu(v, 0.01)

    def replaying(v):
        side = sides.pop(0).to(v.device)
        flips[0] += int(((v > 0) != side).sum())
        flips[1] += v.numel()
        return torch.where(side, v, 0.01 * v)

    got = {}
    real = that_module.leaky_relu
    try:
        for device, leaky_relu in (("cuda", recording), ("cpu", replaying)):
            that_module.leaky_relu = leaky_relu
            model = without_dropout(build_model("THAT", seed=SEED)).to(device)
            step = make_train_step(model, adam_like_torch(
                model.parameters(), cfg.nn.lr, spec.weight_decay),
                spec.make_loss(cfg, 54), augment=False)
            loss, _ = step(torch.from_numpy(x).to(device),
                           torch.from_numpy(y).to(device),
                           torch.Generator(device=device).manual_seed(SEED))
            got[device] = (float(loss), {n: p.grad.detach().cpu() for n, p
                                         in model.named_parameters()})
    finally:
        that_module.leaky_relu = real
    check(not sides, "the CPU step replayed fewer leaky ReLUs than the card")
    (card_loss, card), (cpu_loss, cpu) = got["cuda"], got["cpu"]
    floor = 1e-2 * max(g.abs().max().item() for g in cpu.values())
    worst = max((((card[n] - cpu[n]).abs().max().item()
                  / max(cpu[n].abs().max().item(), floor)), n) for n in cpu)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"THAT f32 training step, card vs CPU: {flips[0]} of {flips[1]} "
          f"leaky-ReLU inputs fell on the other side of the kink on the "
          f"CPU (it took the card's); loss {card_loss:.6f} vs "
          f"{cpu_loss:.6f} (relative {rel:.2e}, tolerance {STEP_F32_TOL}); "
          f"worst gradient {worst[0]:.2e} of its scale in {worst[1]} "
          f"(tolerance {GRAD_F32_TOL})")
    check(rel <= STEP_F32_TOL, f"card vs CPU step loss relative {rel}")
    check(worst[0] <= GRAD_F32_TOL, f"card vs CPU gradient {worst}")


def train_phase_detr(data):
    """DETR's training step at the flagship configuration, batch 16,
    Hungarian matching loss, augmentation on: no kernel launch."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS, build_model
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      make_train_step)
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's own defaults
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
    """run_experiment for THAT_ENCODER and DETR at full width on the card:
    the result JSON, its keys, and THAT_ENCODER's exact launch counts.
    Returns THAT_ENCODER's launch counts."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.data.splits import (env_split,
                                                       valid_test_split)
    from multi_modal_csi_tpu_torch.runners.csi import run_experiment
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's own defaults
    amp_dir = write_run_dataset(work, converted_amp)
    idx = np.arange(RUN_WINDOWS)
    n_train, rest = len(env_split(idx, idx)[0]), env_split(idx, idx)[1]
    n_valid, n_test = (len(a) for a in valid_test_split(rest, rest)[:2])
    steps = RUN_EPOCHS * (math.ceil(n_train / TRAIN_BATCH) - 1)
    chunks = RUN_EPOCHS * math.ceil(n_valid / 512) + math.ceil(n_test / 512)
    out = {}
    for key, want in (("THAT_ENCODER",
                       {"flash_attention": 5 * steps + 5 * chunks,
                        "flash_attention_backward": 5 * steps}),
                      ("DETR", {})):
        save = os.path.join(work, "results", f"{key}.json")
        cfg = Config().override({
            "model": key, "task": "activity", "repeat": 1,
            "path.data_x": amp_dir,
            "path.data_y": os.path.join(work, "annotation.csv"),
            "path.save": save, "data.environment": ["classroom"],
            "nn.epoch": RUN_EPOCHS, "nn.batch_size": TRAIN_BATCH,
            "compute_dtype": "auto"})
        kernels.reset_launch_counts()
        start = time.perf_counter()
        result = run_experiment(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = dict(kernels.LAUNCH_COUNTS)
        with open(save) as f:
            written = json.load(f)
        fit_s = result["time_train"]["avg"]
        print(f"{key} run_experiment: {n_train} training, {n_valid} "
              f"validation, {n_test} test windows; {wall:.2f} s wall, fit "
              f"{fit_s:.2f} s ({steps} steps and {RUN_EPOCHS} validation "
              f"passes: {steps * TRAIN_BATCH / fit_s:.1f} windows trained/s"
              f" over fit's wall time), final bf16 test pass "
              f"{result['time_test']['avg']:.3f} s; PPP "
              f"{result['accuracy']['avg']:.1f}, parameters "
              f"{result['complexity']['parameter']}, forward FLOPs "
              f"{result['complexity']['flops']:.4g}; launches {launches}")
        check(set(written) == RESULT_KEYS,
              f"{key} result JSON keys {sorted(written)}")
        check(written["model"] == key and written["nn"]["epoch"]
              == RUN_EPOCHS and written["data"]["length"] == LENGTH,
              f"{key} result JSON config sections")
        check(all(math.isfinite(written[k]["avg"]) for k in
                  ("accuracy", "time_train", "time_test")),
              f"{key} result JSON values not finite")
        check(launches == want, f"{key} run launched {launches}, expected "
                                f"{want}")
        out[key] = launches
    return out["THAT_ENCODER"]


def lowrank_bound(shape, bias, dtype):
    """The least times (ms) one K3 call needs on an H100 SXM: q, k, v, r
    and s read once and out and the LSE written once over the HBM rate;
    the QK^T and PV products (4 B*H*Nq*Nk*D) over the peak of the dtype
    plus the bias product (2 B*H*Nq*Nk*M) over the f32 peak."""
    b, h, nq, nk, d, m = shape
    m = m if bias else 0
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * nq * d + 2 * b * h * nk * d) * item + 4 * (
        b * h * nq * m + m * nk + b * h * nq)
    ops_ms = 1e3 * (4.0 * b * h * nq * nk * d / PEAK_FLOPS[dtype]
                    + 2.0 * b * h * nq * nk * m / PEAK_FLOPS[torch.float32])
    return 1e3 * nbytes / PEAK_BYTES, ops_ms


def phase_lowrank(lowrank, lowrank_reference):
    """K3 against its plain version at MViT's seven serving shapes and the
    JAX test's odd shapes, f32 and bf16, with and without the bias; then,
    at the serving shapes in bf16, times per call with CUDA events (plain,
    kernel, kernel, plain), beside scaled_dot_product_attention with r @ s
    materialized as its attn_mask in q's dtype (the mask made outside the
    timed call) and the bound; a head dim of 160 must be refused."""
    import torch.nn.functional as F
    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = {n: s for n, (s, _) in LOWRANK_SHAPES.items()}
    shapes.update(LOWRANK_ODD)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape in shapes.items():
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
                check(out.dtype == dtype and out.shape == q.shape
                      and lse.shape == q.shape[:3],
                      f"K3 {label} {dtype} outputs {out.dtype} "
                      f"{tuple(out.shape)} {tuple(lse.shape)}")
                check(err <= tol, f"K3 {label} {dtype} err {err} > {tol}")
                check(lse_rel <= LOWRANK_LSE_RTOL,
                      f"K3 {label} {dtype} LSE rel err {lse_rel}")
                del out, lse, want, want_lse
                if dtype != torch.bfloat16 or name not in LOWRANK_SHAPES:
                    continue

                def timed(fn):
                    return cuda_ms(fn, reps=LOWRANK_REPS, warmup=1)

                plain = [timed(lambda: lowrank_reference(q, k, v, r, s))]
                kern = [timed(lambda: lowrank(q, k, v, r, s))
                        for _ in range(2)]
                plain.append(timed(lambda: lowrank_reference(q, k, v, r, s)))
                mask = None if r is None else (r @ s).to(dtype)
                lib = timed(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask))
                del mask
                bytes_ms, ops_ms = lowrank_bound(shape, bias, dtype)
                results[(label, dtype)] = dict(
                    err=err, ms=sum(kern) / 2, plain_ms=sum(plain) / 2,
                    library_ms=lib, bytes_ms=bytes_ms, ops_ms=ops_ms)
                print(f"K3 {label} {dtype} per call: kernel {kern[0]:.3f}/"
                      f"{kern[1]:.3f} ms, plain {plain[0]:.3f}/{plain[1]:.3f}"
                      f" ms, sdpa {lib:.3f} ms; bound: bytes "
                      f"{1e3 * bytes_ms:.1f} us, operations "
                      f"{1e3 * ops_ms:.1f} us")
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

    q = torch.zeros((1, 1, 8, 160), device="cuda")
    try:
        lowrank(q, q, q)
        refused = False
    except ValueError as e:
        print(f"K3 D=160: refused ({e})")
        refused = True
    check(refused, "K3 launched with a head dim above 128")
    return results


def video_requests():
    rng = np.random.default_rng(SEED)
    return [rng.standard_normal((n, *VIDEO_CLIP, 3), dtype=np.float32)
            for n in VIDEO_REQUESTS]


def video_serve_phase(key, requests):
    """Serve ``requests`` (host arrays of (n, 45, 224, 224, 3) clips) with
    ``key`` in bf16 at batch 2: exactly 16 K3 launches per batch forward,
    clips/s from host memory and resident, a profile; a training forward
    at the flash-backward gate must raise."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.serving import VideoServer
    from multi_modal_csi_tpu_torch.runners.video import build_video_model

    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's own defaults
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
    print(f"{key} bf16 batch {server.batch}: {n / host_s:.2f} clips/s from "
          f"host memory, {n} clips in {batches} batch forwards; with the "
          f"clips already on the card, {RESIDENT_ROUNDS} timings: "
          + ", ".join(f"{r:.2f}" for r in rates) + " clips/s")
    profile_device(key, lambda: server.forward(batch), PROFILED_FORWARDS,
                   "forward")

    server.model.train()
    try:
        with torch.no_grad():
            server.model(batch[:1].to(server.dtype))
        raised = False
    except NotImplementedError as e:
        print(f"{key} training forward on the card: refused ({e})")
        raised = True
    finally:
        server.model.eval()
    check(raised, f"{key} trained at the K4 gate without the K4 kernel")
    return launches


def video_card_vs_cpu(key):
    """The same seeded weights in f32 (TF32 off) at (2, 16, 112, 112, 3)
    on the card and on the CPU, where K3's plain version runs: logits
    within VIDEO_F32_SHARE of the largest."""
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.serving import VideoServer
    from multi_modal_csi_tpu_torch.runners.video import build_video_model
    set_tf32(False)
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
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's own defaults
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


def pending_bounds():
    """Print the least time each TPU kernel still to port needs on an H100
    SXM at a shape its path runs: bytes read once and written once over
    the HBM rate against operations over the peak rate of their type."""
    nq, nk, d, m = 25089, 393, 96, 22     # MViT-v2-S stage 1, 16x224^2
    rows = {
        "K4 flash_attention_lowrank_bias_trainable, MViT-v2-S stage 1, one "
        "(b, h): q (25089, 96), 393 keys, M 22, bf16, f32 bias":
            ((4 * nq * d + 4 * nk * d) * 2 + (2 * nq * m + 2 * m * nk + nq) * 4,
             {torch.bfloat16: 10 * nq * nk * d,
              torch.float32: 6 * nq * nk * m}),
        "P1 kernel_s8, one (256, 272) x (272, 424) s8 -> s32 tile":
            (256 * 272 + 272 * 424 + 256 * 424 * 4,
             {torch.int8: 2 * 256 * 272 * 424}),
        "P1 kernel_bf16, the same tile, bf16 -> f32":
            ((256 * 272 + 272 * 424) * 2 + 256 * 424 * 4,
             {torch.bfloat16: 2 * 256 * 272 * 424}),
    }
    for name, (nbytes, ops) in rows.items():
        bytes_us = 1e6 * nbytes / PEAK_BYTES
        ops_us = 1e6 * sum(count / PEAK_FLOPS[t]
                           for t, count in ops.items())
        print(f"bound of {name}: {nbytes / 1e6:.2f} MB -> {bytes_us:.2f} us "
              f"bytes, {sum(ops.values()) / 1e9:.3f} G operations -> "
              f"{ops_us:.2f} us; bound by "
              f"{'bytes' if bytes_us >= ops_us else 'operations'}")


def build_kernels():
    """Build every kernel, one nvcc for each source, started together."""
    from multi_modal_csi_tpu_torch.kernels import build

    def timed(name):
        start = time.perf_counter()
        build.load(name)
        return time.perf_counter() - start

    names = ("flash_attention", "flash_attention_bwd",
             "flash_attention_lowrank", "csi_preprocess")
    start = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        took = dict(zip(names, pool.map(timed, names)))
    print(f"kernels built and loaded in {time.perf_counter() - start:.1f} s: "
          + ", ".join(f"{n} {t:.1f} s" for n, t in took.items()))
    for name in names:
        for line in build.LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  nvcc {name}: {line.strip()}")


def kernel_entry(name, source, replaces, launches, times, per_call, dtype):
    """The JSON description of one kernel: times and bound summed over the
    launches of one model call (``per_call``: shape name -> launches)."""
    def total(field):
        return sum(n * times[(s, dtype)][field] for s, n in per_call.items())

    bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
    return {
        "name": name, "route": "cuda",
        "source": f"multi_modal_csi_tpu_torch/kernels/csrc/{source}",
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(times[(s, dtype)]["err"] for s in per_call),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": total("library_ms"),
    }


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
        flash_attention_lowrank_bias, flash_attention_lowrank_bias_reference)

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
        del requests

        data = training_data()
        trained = train_phase_that(data)
        train_step_card_vs_cpu(data)
        train_phase_detr(data)
        del data

        experiment = run_csi_phase(work, converted_amp)

        clips = video_requests()
        video = [video_serve_phase(key, clips) for key in
                 ("MViT-v1", "MViT-v2")]
        del clips
        video += [video_card_vs_cpu(key) for key in ("MViT-v1", "MViT-v2")]
        video += [video_evaluate_phase(work, key) for key in
                  ("MViT-v1", "MViT-v2")]

    pending_bounds()
    # K1 and K2: per THAT forward (bf16 serving, batch 256) and per THAT
    # training step (f32, batch 16), 4 left-stream and 1 right-stream
    # launches; launches summed over every main path that ran them. K5:
    # per WiMANS trace (3000, 270). K3: per MViT-v2 forward (bf16, batch
    # 2, the bias on), its 16 launches; launches summed over the video
    # serving, card-vs-CPU and evaluate runs of both variants.
    trace = k5_times["trace"]
    k5_bytes, k5_ops = trace["bytes_ms"], trace["ops_ms"]
    print(json.dumps({"kernels": [
        kernel_entry("flash_attention", "flash_attention.cu",
                     "multi_modal_csi_tpu/kernels/flash_attention.py:108",
                     sum(runs.get("flash_attention", 0) for runs in
                         (that, trained, encoder, experiment)), fwd_times,
                     {"that-left": 4, "that-right": 1}, torch.bfloat16),
        kernel_entry("flash_attention_backward", "flash_attention_bwd.cu",
                     "multi_modal_csi_tpu/kernels/flash_attention.py:271",
                     trained["flash_attention_backward"]
                     + experiment["flash_attention_backward"], bwd_times,
                     {"that-left-16": 4, "that-right-16": 1},
                     torch.float32),
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
                     sum(runs["flash_attention_lowrank_bias"]
                         for runs in video), k3_times,
                     {f"{name}+bias": n
                      for name, (_, n) in LOWRANK_SHAPES.items()},
                     torch.bfloat16),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
