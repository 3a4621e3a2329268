"""The decoder options on the flagship's four contexts against tell_tpu on
the CPU: learned positions (expt 13), the lightweight conv, and the
pre-norm final LayerNorm (normalize_before with final_norm). The loss and
every gradient, greedy, beam 5 and predict_forced
(tests/test_torch_siblings.py's check_case and tolerances)."""
import pytest

from tests.test_torch_siblings import CASES, check_case


@pytest.mark.parametrize("name", ["learned", "lightweight", "final_norm"])
def test_decoder_option_matches_jax(name):
    check_case(CASES[name])
