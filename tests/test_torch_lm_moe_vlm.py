"""The per-case checks of ``tests/test_torch_lm.py`` for the moe and vlm
cases (qwen3-moe-235b-a22b with its qk-norm, dbrx-132b, internvl2-1b with
seeded patch embeddings): parameter counts and names, forward (logits and
the summed MoE aux), prefill, decode and caches against the JAX package,
teacher forcing within the port, and ``ServeEngine`` tokens against the
JAX engine (``extra_batch={"vis_embeds": …}`` for vlm). The checks
themselves are ``test_torch_lm``'s, at its tolerance; they run from this
file so that each file stays under a minute on the CPU."""
import pytest

import test_torch_lm as lm_tests


@pytest.mark.parametrize("case", lm_tests.MOE_VLM)
def test_param_count_and_names(case):
    lm_tests.test_param_count_and_names(case)


@pytest.mark.parametrize("case", lm_tests.MOE_VLM)
def test_forward_prefill_decode_match_jax(case):
    lm_tests.test_forward_prefill_decode_match_jax(case)


@pytest.mark.parametrize("case", lm_tests.MOE_VLM)
def test_prefill_decode_matches_forward(case):
    lm_tests.test_prefill_decode_matches_forward(case)


@pytest.mark.parametrize("case", lm_tests.MOE_VLM)
def test_serve_engine_matches_jax(case):
    lm_tests.test_serve_engine_matches_jax(case)
