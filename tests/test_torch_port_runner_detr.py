"""The port's ``run_csi_model`` for DETR against the JAX package's, on the
CPU: both restored from one reference-layout ``.pt`` at the narrow
(300, 30) shape with 2 decoder layers and ``nn.epoch`` 0, compared as
tests/test_torch_port_runner.py compares THAT_ENCODER (every metric equal,
``complexity.parameter`` equal). A file of its own so that each runner
file stays well under a minute alone.
"""

import torch

from test_torch_port_runner import (assert_same_results,
                                    run_both_from_one_checkpoint)

torch.set_num_threads(1)


def test_detr_run_matches_jax_from_one_checkpoint(tmp_path):
    got, want, model = run_both_from_one_checkpoint("DETR", tmp_path)
    assert_same_results(got, want, model)
    print(got["repeat_0"])
