"""One MViT-v2 training step of the port against the JAX package's, on
the CPU, in f32, at full width and the (1, 8, 64, 64, 3) clip: the eager
step, and the step with the training gate lowered so that block 0 runs
the trainable flash attention (K3 and K4 in their plain versions, with
v2's relative bias as the factor pair r, s). Settings, bounds and helpers
are test_torch_port_mvit_train_v1.py's; this file runs beside it.
"""

import pytest
import torch

from test_torch_port_mvit_train_v1 import check_step, jax_reference

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    return jax_reference("MViT-v2")


@pytest.mark.parametrize("forced", [False, True])
def test_mvit_v2_train_step_matches_jax(reference, monkeypatch, forced):
    calls = check_step("MViT-v2", reference, monkeypatch, forced)
    n = int(forced)
    assert calls == {"trainable": n, "backward": n}
