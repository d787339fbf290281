"""The training checks of ``tests/test_torch_train.py`` for the hybrid arch
(zamba2-1.2b at ``reduced(n_layers=7)``: two groups of three Mamba2 layers,
each followed by the shared attention block, and a one-layer tail; SSD
chunks of 16, so the inter-chunk recurrence runs): one train step from the
same weights, a 5-step loss trajectory and a 2-microbatch step against the
JAX package; and one train step for the other dense configs (yi-6b untied,
stablelm-1.6b layernorm, starcoder2-15b gelu with biases). Tolerances as
there (``tests/_torch_train_cases.py``)."""
import pytest
from _torch_train_cases import (check_microbatches, check_one_step,
                                check_trajectory)


@pytest.mark.parametrize("case", ["zamba2", "yi", "stablelm", "starcoder2"])
def test_one_train_step_matches_jax(case):
    check_one_step(case)


def test_loss_trajectory_matches_jax():
    check_trajectory("zamba2")


def test_microbatches_match_jax():
    check_microbatches("zamba2")
