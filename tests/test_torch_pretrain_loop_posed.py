"""Port parity of the pretraining loop on posed frames (pinhole K and
camera-to-world ``(R, T)``: the posed render path); the setup and the
tolerances of ``test_torch_pretrain_loop.py``."""

from tests.test_torch_pretrain_loop import run_and_compare


def test_run_matches_reference_posed():
    run_and_compare("posed")
