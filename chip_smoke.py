#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (multi_modal_csi_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit, torch and CUDA versions; build the
   attention kernel from csrc/ with nvcc, timed;
2. the attention kernel (K1) against its plain PyTorch version on the card,
   f32 and bf16, at THAT's left (256, 150, 10, 27) and right
   (256, 270, 10, 15) shapes, a ragged (3, 64, 10, 15) case and a cross
   case (Nq 128, Nk 420, 6 heads of 45); then per-launch times with CUDA
   events in the order plain, kernel, kernel, plain, beside
   scaled_dot_product_attention's time on the same inputs (a yardstick the
   port never calls) and the card's bound for the same work; a K and V too
   large for shared memory must raise;
3. THAT serving at full width, bf16, batch 256: seeded weights, ragged
   requests of 256, 100 and 300 seeded windows, exactly 5 kernel launches
   per batch forward; windows/s from host memory, and with the requests
   already on the card; 5 batch forwards under torch.profiler for the
   device time per forward, the device's busy share and the kernels with
   the most device time; then the same weights at f32 (TF32 off, batch 4)
   against the CPU, where the plain versions run;
4. DETR serving at the flagship configuration, the same steps, with no
   kernel launch;
5. one JSON line describing each ported kernel, then the card's name and
   power limit, then the result line.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
RESIDENT_ROUNDS = 3        # timings of the requests already on the card
PROFILED_FORWARDS = 5
TOP_KERNELS = 12           # listed from the profile, by device time
KERNEL_SHAPES = {          # name: (q shape (B, Nq, H, D), Nk)
    "that-left": ((256, 150, 10, 27), 150),
    "that-right": ((256, 270, 10, 15), 270),
    "ragged": ((3, 64, 10, 15), 64),
    "cross": ((4, 128, 6, 45), 420),
}


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


def profile_forwards(key, server, x):
    """Device time of PROFILED_FORWARDS batch forwards of ``x`` (already on
    the card) by kernel, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = time.perf_counter()
        for _ in range(PROFILED_FORWARDS):
            server.forward(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    check(device_us > 0, f"{key}: the profile holds no device time")
    print(f"{key} profiled: {device_us / 1e3 / PROFILED_FORWARDS:.3f} ms "
          f"device time per forward; device busy "
          f"{100 * device_us / 1e6 / wall:.1f}% of {wall * 1e3:.1f} ms wall "
          f"({PROFILED_FORWARDS} forwards, profiler on)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total
                    )[:TOP_KERNELS]:
        share = 100 * e.self_device_time_total / device_us
        ms = e.self_device_time_total / 1e3 / PROFILED_FORWARDS
        print(f"  {share:5.1f}%  {ms:8.3f} ms/forward  "
              f"{e.count // PROFILED_FORWARDS:4d}x  {e.key[:90]}")


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
    profile_forwards(key, server, resident[0][:server.batch])
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from multi_modal_csi_tpu_torch.kernels import build
    from multi_modal_csi_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference)

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    start = time.perf_counter()
    build.load("flash_attention")
    print(f"flash_attention: built and loaded in "
          f"{time.perf_counter() - start:.1f} s")
    for line in build.LOGS.get("flash_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  nvcc: {line.strip()}")

    times = phase_kernel(flash_attention, flash_attention_reference)

    rng = np.random.default_rng(SEED)
    requests = [rng.standard_normal((n, LENGTH, CHANNELS), dtype=np.float32)
                for n in REQUESTS]
    that = serve_phase("THAT", requests, lambda n: (n, 54), 5)
    detr = serve_phase("DETR", requests, lambda n: (6, n, 5, 10), 0)
    check("flash_attention" not in detr,
          "DETR launched the attention kernel")

    # per THAT forward: 4 left-stream and 1 right-stream launches, bf16
    per_forward = {"that-left": 4, "that-right": 1}

    def total(field):
        return sum(n * times[(s, torch.bfloat16)][field]
                   for s, n in per_forward.items())

    bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "multi_modal_csi_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "multi_modal_csi_tpu/kernels/flash_attention.py:108",
        "launches": that.get("flash_attention", 0),
        "max_abs_err": max(times[(s, torch.bfloat16)]["err"]
                           for s in per_forward),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": total("library_ms"),
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
