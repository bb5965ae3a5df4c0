"""The `masked_peel` case of tests/test_torch_frame_branches.py (the
textured leaf cards at render size with masked_layers=2: the depth peel),
its tests and tolerances unchanged, in a file of its own: chord_tpu's
interpret-mode compile of this frame takes minutes, and a run that
spreads test files over workers then renders it beside the file's other
cases.
"""

import pytest

import test_torch_frame_branches as base
from test_torch_frame_branches import CASES, _run_jax, _run_torch

PEEL = ["masked_peel"]


@pytest.fixture(scope="module")
def runs():
    """The case's runs, made once on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = dict(jax=_run_jax(case), torch=_run_torch(case))
        return cache[case]
    return get


@pytest.mark.parametrize("case", PEEL)
def test_branch_stats_match_exactly(runs, case):
    base.test_branch_stats_match_exactly(runs, case)


@pytest.mark.parametrize("case", PEEL)
def test_branch_visibility_matches_exactly(runs, case):
    base.test_branch_visibility_matches_exactly(runs, case)


@pytest.mark.parametrize("case", PEEL)
def test_branch_images_match(runs, case):
    base.test_branch_images_match(runs, case)


def test_masked_peel_covers_and_changes_the_frame(runs):
    """chord_tpu's palette covered every pixel (3 sampler calls a frame:
    the resolve and the alpha tests of the two masked layers), and the
    second masked layer changes the frame: the peel finds masked fragments
    behind failed alpha tests."""
    r = runs("masked_peel")
    coverage = r["jax"][3]
    assert len(coverage) == 3 * CASES["masked_peel"]["frames"], coverage
    assert min(coverage) == 1.0, coverage
    one_layer = _run_torch("masked_peel", masked_layers=1)
    assert (one_layer[0] != r["torch"][0]).mean() > 0.005
    assert (one_layer[2][-1] != r["torch"][2][-1]).mean() > 0.002
