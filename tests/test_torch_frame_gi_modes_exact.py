"""The `exact` mode of tests/test_torch_frame_gi_modes.py (the
triangle-exact BVH with RTAO and the probe march), its tests and
tolerances unchanged, in a file of its own: chord_tpu's interpret-mode
compile of the mode and the port's renders of it take minutes, and a run
that spreads test files over workers then renders the two modes at once.
"""

import pytest

from test_torch_frame_gi_modes import make_runs
from test_torch_frame_gi_modes import (  # noqa: F401  (collected here)
    test_gi_modes_bvh_matches, test_gi_modes_history_matches,
    test_gi_modes_images_match, test_gi_modes_renderer,
    test_gi_modes_stats_match_exactly, test_gi_modes_trace_their_rays)


@pytest.fixture(scope="module", params=("exact",))
def runs(request):
    return make_runs(request.param)
