"""The training checks of ``tests/test_torch_train.py`` for the moe, vlm and
encdec archs (qwen3-moe-235b-a22b with its qk-norm and MoE aux loss,
dbrx-132b, internvl2-1b with seeded patch embeddings and the prefix cut
from the loss, whisper-tiny with seeded frames): one train step from the
same weights (loss and metrics 1e-5 relative, every gradient leaf
1e-4·max|g|), a 5-step loss trajectory (1e-4) and a 2-microbatch step
against the JAX package (``tests/_torch_train_cases.py``)."""
import pytest
from _torch_train_cases import (check_microbatches, check_one_step,
                                check_trajectory)

CASES = ("qwen3-moe", "dbrx", "internvl2", "whisper")


@pytest.mark.parametrize("case", CASES)
def test_one_train_step_matches_jax(case):
    check_one_step(case)


@pytest.mark.parametrize("case", CASES)
def test_loss_trajectory_matches_jax(case):
    check_trajectory(case)


@pytest.mark.parametrize("case", CASES)
def test_microbatches_match_jax(case):
    check_microbatches(case)
