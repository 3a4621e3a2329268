"""The port's evaluate_split with the int8 tower (--enc8) against
tell_tpu's under TELL_TPU_ENC8, greedy, on the CPU: the checks and setup
of tests/test_torch_dec8_evaluate.py (generations identical line for
line, metrics equal but the timing keys), each package's tower quantised
as its command line does, in a file of its own so that each file runs in
under 30 s.
"""
from tests.test_torch_dec8_evaluate import check_evaluate
from tests.test_torch_dec8_evaluate import setup  # noqa: F401


def test_evaluate_split_with_the_int8_tower_equals_jax(setup, monkeypatch):
    check_evaluate(setup, monkeypatch, 1, ("enc8",))
