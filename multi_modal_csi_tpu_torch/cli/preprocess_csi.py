"""CSI preprocessing CLI: raw WiMANS ``.mat`` traces to amplitude (and
phase) ``.npy`` files, the port of the JAX package's
``cli/preprocess_csi.py``.

Each trace is parsed once (scipy), and its amplitude and phase come from
one pass over the whole (T, 3, 3, 30) trace: on the card by the CUDA kernel
``kernels/csi_preprocess.py::amplitude_phase`` (``--device cuda``, the
default), or on the host with ``np.abs`` and ``np.angle`` (``--device
cpu``), the reference's and the JAX host path's arithmetic. The two differ
in the last bit of some amplitudes (the card computes sqrt(re^2 + im^2),
numpy a hypot) and phases (CUDA's atan2f and the C library's differ by a
few ulp).

Usage:
  python -m multi_modal_csi_tpu_torch.cli.preprocess_csi \\
      --dir_mat dataset/wifi_csi/mat --dir_amp dataset/wifi_csi/amp \\
      [--dir_phase dataset/wifi_csi/phase] [--device cuda|cpu] [--workers 1]
"""

from __future__ import annotations

import argparse
import os
import time
from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels.csi_preprocess import amplitude_phase

STAGES = ("parse", "copy", "kernel", "fetch", "save")


def mat_trace_to_complex(data_mat) -> np.ndarray:
    """The per-packet CSI of a loaded ``.mat`` trace: WiMANS stores an
    object cell of nested structs whose LAST field is the (3, 3, 30)
    complex CSI (reference wifi_csi/preprocess.py:27). Stacks to
    (T, 3, 3, 30) complex64."""
    trace = data_mat["trace"]
    packets = [trace[t][0][0][0][-1] for t in range(trace.shape[0])]
    return np.asarray(packets, dtype=np.complex64)


def extract_amplitude(csi: np.ndarray, device: str = "cpu",
                      seconds: Optional[Dict[str, float]] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(T, 3, 3, 30) complex to (amp, phase) float32 of the same shape.

    ``device="cpu"`` is numpy's ``abs`` and ``angle``; a CUDA device copies
    the real and imaginary parts to the card as (T, 270) arrays, runs the
    amplitude-phase kernel once and fetches both results. ``seconds``, if
    given, gets each stage's wall seconds added under "copy", "kernel" and
    "fetch" (the card is synchronised after each).
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return (np.abs(csi).astype(np.float32),
                np.angle(csi).astype(np.float32))
    flat = csi.reshape(csi.shape[0], -1)
    marks = [time.perf_counter()]
    re = torch.from_numpy(np.ascontiguousarray(flat.real)).to(dev)
    im = torch.from_numpy(np.ascontiguousarray(flat.imag)).to(dev)
    torch.cuda.synchronize(dev)
    marks.append(time.perf_counter())
    amp, phase = amplitude_phase(re, im)
    torch.cuda.synchronize(dev)
    marks.append(time.perf_counter())
    amp = amp.cpu().numpy().reshape(csi.shape)
    phase = phase.cpu().numpy().reshape(csi.shape)
    marks.append(time.perf_counter())
    if seconds is not None:
        for stage, t0, t1 in zip(("copy", "kernel", "fetch"), marks,
                                 marks[1:]):
            seconds[stage] = seconds.get(stage, 0.0) + t1 - t0
    return amp, phase


def _convert_one(job) -> tuple:
    """One trace: loadmat, amplitude and phase, save. Returns the output
    name, the amplitude's shape and each stage's wall seconds. At module
    level so that it pickles for the worker pool."""
    import scipy.io as scio
    path_mat, dir_amp, dir_phase, device = job
    seconds: Dict[str, float] = {}
    t0 = time.perf_counter()
    csi = mat_trace_to_complex(scio.loadmat(path_mat))
    seconds["parse"] = time.perf_counter() - t0
    amp, phase = extract_amplitude(csi, device, seconds)
    t0 = time.perf_counter()
    out = os.path.basename(path_mat).replace(".mat", ".npy")
    np.save(os.path.join(dir_amp, out), amp)
    if dir_phase:
        np.save(os.path.join(dir_phase, out), phase)
    seconds["save"] = time.perf_counter() - t0
    return out, amp.shape, seconds


def extract_csi_amp(dir_mat: str, dir_amp: str,
                    dir_phase: Optional[str] = None,
                    device: str = "cuda", workers: int = 1,
                    seconds: Optional[Dict[str, float]] = None) -> int:
    """Convert every ``.mat`` in ``dir_mat`` (sorted by name); returns the
    number converted. ``workers > 1`` fans the traces, which are
    independent, over a process pool, on the CPU only: with ``cuda`` it
    raises. ``seconds``, if given, gets each stage's wall seconds summed
    over the traces (see ``STAGES``)."""
    if workers > 1 and device != "cpu":
        raise ValueError("workers > 1 runs on the CPU only; the card path "
                         "is one process (one card)")
    resolve_device(device)          # no card: raise before any work
    os.makedirs(dir_amp, exist_ok=True)
    if dir_phase:
        os.makedirs(dir_phase, exist_ok=True)
    jobs = [(os.path.join(dir_mat, name), dir_amp, dir_phase, device)
            for name in sorted(os.listdir(dir_mat)) if name.endswith(".mat")]
    totals: Counter = Counter()
    if workers > 1:
        import multiprocessing
        # spawn, not fork: this process may already run threads (torch's)
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            results = pool.imap_unordered(_convert_one, jobs)
            for i, (_, shape, took) in enumerate(results, 1):
                print(i, shape)
                totals.update(took)
    else:
        for i, job in enumerate(jobs, 1):
            _, shape, took = _convert_one(job)
            print(i, shape)
            totals.update(took)
    if seconds is not None:
        for stage, value in totals.items():
            seconds[stage] = seconds.get(stage, 0.0) + value
    return len(jobs)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dir_mat", default="dataset/wifi_csi/mat")
    p.add_argument("--dir_amp", default="dataset/wifi_csi/amp")
    p.add_argument("--dir_phase", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the amplitude-phase kernel on the card; "
                        "cpu: numpy on the host")
    p.add_argument("--workers", type=int, default=1,
                   help="process-pool width, --device cpu only (traces are "
                        "independent; the host path is .mat-parse-bound)")
    args = p.parse_args(argv)
    t0 = time.time()
    seconds: Dict[str, float] = {}
    n = extract_csi_amp(args.dir_mat, args.dir_amp, args.dir_phase,
                        args.device, workers=args.workers, seconds=seconds)
    print(f"converted {n} traces in {time.time() - t0:.1f}s; stage seconds "
          + ", ".join(f"{s} {seconds[s]:.3f}" for s in STAGES
                      if s in seconds))


if __name__ == "__main__":
    main()
