"""Entry points of the port (counterparts of the JAX package's
``__graft_entry__.py``).

- ``entry(device)``: the flagship forward, ready to call: DETR at
  (8, 3000, 270) windows (10 tokens, 6 weight-shared decoder layers,
  temperature 2.0, a 512-wide FFN), in eval mode, with weights drawn from
  a seed, and its example input.
- ``dryrun_multichip(n_devices, device)``: one pass over the whole
  parallel layer on ``n_devices`` ranks, at JAX's shapes and with JAX's
  asserts:
  - a ("data", "model") mesh of n / m x m ranks, m = 2 for an even n;
  - one training step of a small DETR (augmentation, dropout, the
    Hungarian loss, ``adam_like_torch(5e-4, 2e-4)``) with the
    tensor-parallel rules applied and the batch split over "data";
  - ring attention over "data" at a sequence of 16 per data rank, against
    full attention (error under 1e-3);
  - GPipe over the largest pipe of 1, 2 or 4 stages that n allows,
    against the stages run one after the other (error under 1e-5;
    skipped at one stage);
  - ``fit`` of MLP with FSDP2 over every rank, and ``fit_video`` of
    ResNet3D-18 data-parallel;
  - one summary line, printed by rank 0.

  It joins the process group that torchrun's environment describes (or
  the one already joined); without one it starts the ``n_devices`` ranks
  itself, one process each (a single rank runs in this process). On the
  card ("cuda") every rank takes the card of its ``LOCAL_RANK``
  (``parallel/mesh.py::local_device``), so ranks this call starts may
  not outnumber the cards visible, while a group torchrun started may
  span nodes; the group is NCCL, and gloo only for ``device="cpu"``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Callable, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device]
SPAWN_TIMEOUT = 1200       # seconds for self-started ranks to finish


def entry(device: DeviceLike = "cuda", seed: int = 0
          ) -> Tuple[Callable[[torch.Tensor], torch.Tensor],
                     Tuple[torch.Tensor]]:
    """``(forward, (x,))``: DETR's eval-mode forward without autograd, on
    ``device`` (the card unless the CPU is asked for), and a zero
    (8, 3000, 270) batch there. ``forward.model`` is the module, whose
    weights come from ``seed``."""
    from .core.device import resolve_device
    from .models.csi.detr import DETRMultiUser
    device = resolve_device(device)
    model = DETRMultiUser(token_length=10, num_decoder_layers=6,
                          temp_cross=2.0, num_queries=5, dim_feedforward=512,
                          generator=torch.Generator().manual_seed(seed))
    model.to(device).eval()
    x = torch.zeros((8, 3000, 270), dtype=torch.float32, device=device)

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        return model(x)

    forward.model = model
    return forward, (x,)


def _spawn(n_devices: int, device: DeviceLike) -> None:
    """Start ``n_devices`` processes with torchrun's environment, each
    running ``dryrun_multichip``; print rank 0's output; raise if a rank
    fails or they outlast SPAWN_TIMEOUT (every rank is killed then)."""
    from .parallel.mesh import free_port
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(n_devices),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    if torch.device(device).type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    code = ("from multi_modal_csi_tpu_torch.entry import dryrun_multichip\n"
            f"dryrun_multichip({n_devices}, {str(device)!r})\n")
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n_devices)]
    logs = []
    try:
        for rank, p in enumerate(procs):
            log, _ = p.communicate(timeout=SPAWN_TIMEOUT)
            logs.append(log)
            if p.returncode != 0:
                raise RuntimeError(f"dryrun_multichip: rank {rank} failed "
                                   f"(exit {p.returncode}):\n{log[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(logs[0], end="")


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda") -> None:
    """The parallel layer once on ``n_devices`` ranks (module docstring):
    in the group torchrun's environment describes (or the one already
    joined), else in ranks this call starts."""
    from .parallel.mesh import (_backend, initialize_distributed,
                                one_rank_group)
    _backend(device)                 # no card, no NCCL: raise, never the CPU
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        initialize_distributed(device=device)
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a group of "
                             f"{dist.get_world_size()} ranks")
        if dist.get_backend() != _backend(device):
            raise RuntimeError(f"the process group runs "
                               f"{dist.get_backend()}, device "
                               f"{torch.device(device).type!r} needs "
                               f"{_backend(device)}")
        _dryrun(n_devices, torch.device(device))
    elif torch.device(device).type == "cuda" and (
            n_devices > torch.cuda.device_count()):
        # the ranks this call starts share this node's cards; a group
        # torchrun started may span nodes, each rank on its LOCAL_RANK
        raise ValueError(f"dryrun_multichip({n_devices}) on the card needs "
                         f"{n_devices} cards, {torch.cuda.device_count()} "
                         f"are visible")
    elif n_devices == 1:
        with one_rank_group(device):
            _dryrun(1, torch.device(device))
    else:
        _spawn(n_devices, device)


def _dryrun(n: int, device: torch.device) -> None:
    from .data.video_io import ArrayClips
    from .kernels.ring_attention import (full_attention_reference,
                                         ring_attention)
    from .losses.basic import bce_with_logits
    from .losses.matching import HungarianMatchingLoss
    from .models.csi.detr import DETRMultiUser
    from .models.csi.mlp import MLP
    from .models.video import ResNet3D18
    from .parallel.collectives import axis_index, axis_scope, pmean
    from .parallel.mesh import (batch_sharding, create_mesh, local_device,
                                shard_batch)
    from .parallel.partition import apply_tensor_parallel, fsdp_spec
    from .parallel.pipeline import (pipeline_apply, serial_reference,
                                    stack_stage_params)
    from .runners.video import fit_video
    from .train.loop import adam_like_torch, fit, make_train_step

    if device.type == "cuda":
        device = torch.device("cuda", local_device())
        torch.cuda.set_device(device)

    def largest(err: float) -> float:
        """The largest of every rank's ``err``."""
        t = torch.tensor([err], dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    model_par = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = create_mesh({"data": n // model_par, "model": model_par})
    sharding = batch_sharding(mesh)

    # a small DETR, 6 heads and FFN 64 that the model axis shards
    model = DETRMultiUser(token_length=10, num_decoder_layers=2,
                          num_queries=5, dim_feedforward=64, length=300,
                          channels=30,
                          generator=torch.Generator().manual_seed(0))
    batch = max(2 * (n // model_par), 2)
    x = np.random.default_rng(0).normal(size=(batch, 300, 30)).astype(
        np.float32)
    y = np.zeros((batch, 5, 10), np.float32)
    y[..., -1] = 1.0
    model.to(device)
    apply_tensor_parallel(model, mesh)
    step = make_train_step(
        model, adam_like_torch(model.parameters(), 5e-4, 2e-4),
        HungarianMatchingLoss(), augment=True, sharding=sharding)
    bx, by = (torch.from_numpy(shard_batch(sharding, a)).to(device)
              for a in (x, y))
    loss, _ = step(bx, by, torch.Generator(device=device).manual_seed(1))
    with axis_scope(mesh):
        loss = float(pmean(loss, "data").item())      # the global batch's
    assert np.isfinite(loss), "multichip train step produced non-finite loss"

    # sequence parallelism: ring attention over "data"
    seq_rank = 16
    seq = seq_rank * (n // model_par)
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, seq, 8)).astype(
        np.float32)).to(device) for _ in range(3))
    with axis_scope(mesh):
        block = slice(axis_index("data") * seq_rank,
                      (axis_index("data") + 1) * seq_rank)
        out = ring_attention(q[:, :, block], k[:, :, block],
                             v[:, :, block], "data")
    ref_out = full_attention_reference(q, k, v)[:, :, block]
    sp_err = largest((out - ref_out).abs().max().item())
    assert sp_err < 1e-3, f"ring attention diverged: {sp_err}"

    # pipeline parallelism: GPipe over a "pipe" axis == the serial stages;
    # every group of n_pipe ranks runs the same pipeline
    n_pipe = max(d for d in (1, 2, 4) if n % d == 0 and d <= n)
    if n_pipe >= 2:
        prng = np.random.default_rng(2)
        stacked = stack_stage_params([
            {"w": torch.from_numpy(prng.normal(size=(16, 16)).astype(
                np.float32) / 4.0).to(device),
             "b": torch.from_numpy(prng.normal(size=(16,)).astype(
                 np.float32)).to(device)} for _ in range(n_pipe)])

        def stage(p, x):
            return x + torch.tanh(x @ p["w"] + p["b"])

        mb = torch.from_numpy(prng.normal(size=(3, 2, 16)).astype(
            np.float32)).to(device)
        pipe_mesh = create_mesh({"replica": n // n_pipe, "pipe": n_pipe})
        with axis_scope(pipe_mesh):
            pp_out = pipeline_apply(stage, stacked, mb)
        pp_err = largest((pp_out - serial_reference(stage, stacked, mb))
                         .abs().max().item())
        assert pp_err < 1e-5, f"pipeline parallel diverged: {pp_err}"
    else:
        pp_err = float("nan")

    # FSDP: MLP's fit with the parameters and Adam's moments sharded over
    # every rank; at one rank the rule replicates (nothing to shard over)
    fs_mesh = create_mesh({"data": n, "model": 1})
    frng = np.random.default_rng(3)
    fx = frng.normal(size=(32, 256)).astype(np.float32)
    fy = (frng.random(size=(32, 18)) < 0.3).astype(np.float32)
    fres = fit(MLP(18, in_features=256,
                   generator=torch.Generator().manual_seed(0)),
               fx, fy, fx, fy,
               loss_fn=lambda o, t: bce_with_logits(o, t, 4.0),
               mode="baseline", lr=1e-3, epochs=1, batch_size=16, seed=39,
               augment=False, patience=5, sharding=batch_sharding(fs_mesh),
               fsdp=True, device=device)
    fsdp_loss = fres.history[-1]["train_loss"]
    assert np.isfinite(fsdp_loss), "fsdp step produced non-finite loss"
    assert n == 1 or fsdp_spec((256, 256), fs_mesh) != (), \
        "fsdp spec degenerate"

    # video data parallelism: fit_video of ResNet3D-18 over every rank
    vrng = np.random.default_rng(4)
    vb = 2 * n
    vx = vrng.normal(size=(2 * vb, 4, 16, 16, 3)).astype(np.float32)
    vy = (vrng.random(size=(2 * vb, 6)) < 0.3).astype(np.int64)
    vtrain, vtest = ArrayClips(vx, vy), ArrayClips(vx[:vb], vy[:vb])
    v_mesh = create_mesh({"data": n, "model": 1})
    _, v_acc = fit_video(
        ResNet3D18(6, (4, 16, 16), generator=torch.Generator().manual_seed(0)),
        vtrain, vtest, lr=1e-3, epochs=1, batch_size=vb, seed=39,
        threshold=0.5, verbose=False, num_workers=1,
        sharding=batch_sharding(v_mesh), device=device)
    assert np.isfinite(v_acc), "video DP fit produced non-finite accuracy"

    if dist.get_rank() == 0:
        shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        print(f"dryrun_multichip({n}): mesh={shape} "
              f"dp+tp loss={loss:.4f} sp ring-attn err={sp_err:.2e} "
              f"pp err={pp_err:.2e} fsdp loss={fsdp_loss:.4f} "
              f"video-dp acc={v_acc:.4f} OK", flush=True)
