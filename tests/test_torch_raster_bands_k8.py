"""K8's cases of tests/test_torch_raster_bands.py (the block
decomposition of csrc/raster_subtile.cu), their tests unchanged, in a file
of their own: evaluating K8's blocks one by one takes minutes, and a run
that spreads test files over workers then evaluates them beside the
other kernels' cases.
"""

import pytest

from test_torch_raster_bands import CASES, _case_id, make_case
from test_torch_raster_bands import (  # noqa: F401  (collected here)
    test_bands_cover_each_visit_once_in_queue_order,
    test_block_by_block_evaluation_equals_plain)


@pytest.fixture(params=[c for c in CASES if c[0] == "k8"], ids=_case_id)
def case(request):
    return make_case(request.param)
