"""The port's loss and every gradient against the JAX package's at
``prefix_temporal_length`` 3 (39 frames, windows of 3 + 12 frames, 3 scenes,
4 text tokens), both variants, within tests/test_torch_long_context.py's
GRAD_REL_L2 1e-4; prefix 2 and the window gather and stitch are in
tests/test_torch_prefix_windows.py.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_long_context import VARIANTS, check_loss_and_gradients_match_jax  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefix_3_loss_and_gradients_match_jax(variant):
    check_loss_and_gradients_match_jax("39f_prefix_3", variant)
