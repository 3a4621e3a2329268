"""Greedy and beam-5 search of tell_tpu_torch under dec8 and under dec8 +
dec8_sm against tell_tpu's jitted generate and beam_search under
TELL_TPU_DEC8 (and TELL_TPU_DEC8_SM), on the CPU: the checks, inputs and
tolerances of tests/test_torch_dec8_search.py (ids equal, log-probs and
scores 1e-5, the port's decode on tell_tpu's step tables, for the reason
given there), in a file of their own so that each file runs in under 30 s.
"""
import pytest

from tests.test_torch_dec8 import model  # noqa: F401
from tests.test_torch_dec8_search import check_searches


@pytest.mark.parametrize("lever", ["dec8", "dec8+dec8_sm"])
def test_searches_equal_jax_under_dec8(model, monkeypatch, lever):
    check_searches(model, monkeypatch, lever)
