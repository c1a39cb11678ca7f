#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (multi_modal_csi_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit, torch and CUDA versions; build both
   kernels (attention forward K1 and backward K2) from csrc/ with one nvcc
   each, started together, timed, with nvcc's register and spill lines;
2. K1 against its plain PyTorch version on the card, f32 and bf16, at
   THAT's left (256, 150, 10, 27) and right (256, 270, 10, 15) shapes, a
   ragged (3, 64, 10, 15) case and a cross case (Nq 128, Nk 420, 6 heads of
   45); then per-launch times with CUDA events in the order plain, kernel,
   kernel, plain, beside scaled_dot_product_attention's time on the same
   inputs (a yardstick the port never calls) and the card's bound for the
   same work; a K and V too large for shared memory must raise;
3. K2 against its plain version, f32 and bf16, at THAT's training shapes
   at batch 16 and 256, a ragged (3, 70, 10, 15) case with 97 keys and a
   cross case (4, 128, 6, 45) with 300 keys; per-launch times as for K1,
   beside the backward of scaled_dot_product_attention on the same inputs
   and the bound; a Q, dO, K and V too large for shared memory must raise;
4. THAT serving at full width, bf16, batch 256: seeded weights, ragged
   requests of 256, 100 and 300 seeded windows, exactly 5 K1 launches per
   batch forward; windows/s from host memory, and with the requests
   already on the card; 5 batch forwards under torch.profiler for the
   device time per forward, the device's busy share and the kernels with
   the most device time; then the same weights at f32 (TF32 off, batch 4)
   against the CPU, where the plain versions run;
5. DETR serving at the flagship configuration, the same steps, with no
   kernel launch;
6. THAT training at full width through ``fit``: seeded (80, 3000, 270)
   training and (32, 3000, 270) validation windows, activity labels,
   batch 16, 2 epochs, augmentation on, f32; exactly 5 K1 and 5 K2
   launches in one training step; windows trained per second after a
   warm-up step; 5 steps under torch.profiler; then one bf16 epoch;
7. one f32 THAT training step on the card against the CPU (TF32 off,
   batch 2, augmentation and dropout off, the CPU taking the card's side
   at every leaky-ReLU kink): loss and gradients;
8. DETR's training step at the flagship configuration, batch 16, with the
   Hungarian matching loss and augmentation: finite loss, no kernel
   launch, windows/s;
9. the bound of each TPU kernel still to port, worked out from a shape
   its path runs; one JSON line describing each ported kernel, then the
   card's name and power limit, then the result line.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
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


def pending_bounds():
    """Print the least time each TPU kernel still to port needs on an H100
    SXM at a shape its path runs: bytes read once and written once over
    the HBM rate against operations over the peak rate of their type."""
    nq, nk, d, m = 25089, 393, 96, 22     # MViT-v2-S stage 1, 16x224^2
    n = LENGTH * CHANNELS
    rows = {
        "K3 flash_attention_lowrank_bias, MViT-v2-S stage 1, one (b, h): "
        "q (25089, 96), 393 keys, M 22, bf16, f32 bias":
            ((2 * nq * d + 2 * nk * d) * 2 + (nq * m + m * nk + nq) * 4,
             {torch.bfloat16: 4 * nq * nk * d, torch.float32: 2 * nq * nk * m}),
        "K4 flash_attention_lowrank_bias_trainable, the same shape":
            ((4 * nq * d + 4 * nk * d) * 2 + (2 * nq * m + 2 * m * nk + nq) * 4,
             {torch.bfloat16: 10 * nq * nk * d,
              torch.float32: 6 * nq * nk * m}),
        "K5 amplitude_phase, one (3000, 270) f32 window":
            (3 * n * 4, {torch.float32: 4 * n}),
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

    names = ("flash_attention", "flash_attention_bwd")
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
    from multi_modal_csi_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward,
        flash_attention_backward_reference, flash_attention_reference)

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    build_kernels()

    fwd_times = phase_kernel(flash_attention, flash_attention_reference)
    bwd_times = phase_backward(flash_attention_backward,
                               flash_attention_backward_reference)

    rng = np.random.default_rng(SEED)
    requests = [rng.standard_normal((n, LENGTH, CHANNELS), dtype=np.float32)
                for n in REQUESTS]
    that = serve_phase("THAT", requests, lambda n: (n, 54), 5)
    detr = serve_phase("DETR", requests, lambda n: (6, n, 5, 10), 0)
    check("flash_attention" not in detr,
          "DETR launched the attention kernel")
    del requests

    data = training_data()
    trained = train_phase_that(data)
    train_step_card_vs_cpu(data)
    train_phase_detr(data)

    pending_bounds()
    # per THAT forward (bf16 serving, batch 256) and per THAT training
    # step (f32, batch 16): 4 left-stream and 1 right-stream launches
    print(json.dumps({"kernels": [
        kernel_entry("flash_attention", "flash_attention.cu",
                     "multi_modal_csi_tpu/kernels/flash_attention.py:108",
                     that.get("flash_attention", 0)
                     + trained["flash_attention"], fwd_times,
                     {"that-left": 4, "that-right": 1}, torch.bfloat16),
        kernel_entry("flash_attention_backward", "flash_attention_bwd.cu",
                     "multi_modal_csi_tpu/kernels/flash_attention.py:271",
                     trained["flash_attention_backward"], bwd_times,
                     {"that-left-16": 4, "that-right-16": 1},
                     torch.float32),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
