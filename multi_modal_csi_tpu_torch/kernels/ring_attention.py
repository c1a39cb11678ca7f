"""Ring attention: exact attention with the sequence sharded over a mesh
axis (counterpart of the JAX package's ``kernels/ring_attention.py``,
which is not a Pallas kernel: JAX computes it with einsums and
``ppermute`` outside any kernel, and so does the port).

Each rank holds its (B, H, N / n, D) block of q, k and v. The queries
stay put while the K/V blocks travel the ring by ``ppermute``; each block
is folded into a streaming softmax (the running row max, normaliser and
unnormalised output in f32, as JAX's ``_block_attend``), so the result is
full attention at 1/n of the memory a rank holds. The backward is
autograd through the same loop, whose hops send the gradients back along
the ring (JAX's transpose of ``ppermute``); no hand-written ring backward
is needed. JAX's loop rotates the blocks once more after the last one is
folded in; the port skips that hop, whose result goes unread.

The einsums are f32 matrix products at PyTorch's default precision, with
TF32 off (``torch.backends.cuda.matmul.allow_tf32`` is False unless a
caller sets it): the counterpart of JAX's ``precision=HIGHEST``, the
precision its correctness checks ask for. Nothing here turns TF32 on.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..parallel.collectives import axis_size, ppermute

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  m_prev: torch.Tensor, l_prev: torch.Tensor,
                  o_prev: torch.Tensor, scale: float) -> Stats:
    """One K/V block of streaming-softmax attention: q (B, H, Nq, D), k
    and v (B, H, Nk, D); m, l, o the running max, normaliser and
    unnormalised output, f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    correction = torch.exp(m_prev - m_new)
    l_new = l_prev * correction + p.sum(dim=-1)
    o_new = o_prev * correction[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v.float())
    return m_new, l_new, o_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: str = "data") -> torch.Tensor:
    """Exact attention over the whole sequence, sharded over ``axis``:
    q, k and v are this rank's (B, H, N / n, D) blocks (rank r holds
    positions r N / n onwards) and the result is this rank's block of the
    output, in q's dtype. Every rank of the axis calls it inside
    ``axis_scope``; unbound it is full attention over the blocks given."""
    n = axis_size(axis)
    scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, nq, d = q.shape
    m = torch.full((b, h, nq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, nq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, nq, d), dtype=torch.float32, device=q.device)
    perm = [(j, (j + 1) % n) for j in range(n)]
    for i in range(n):
        m, l, o = _block_attend(q, k, v, m, l, o, scale)
        if i < n - 1:
            k, v = ppermute(k, axis, perm), ppermute(v, axis, perm)
    return (o / l[..., None]).to(q.dtype)


def full_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v in f32, returned in q's dtype: the
    oracle of ``ring_attention``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
