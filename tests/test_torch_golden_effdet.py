"""The port's EfficientDet-Lite0..4 detect steps on the bundled
photographs, held to the stored photo goldens
(tests/data/goldens/efficientdet_lite<n>.json) at full size, in f32 with
the model's default NMS mode, as watsor_tpu/testing/golden.py
``build_golden_detector`` makes them. JAX only builds the PRNGKey(0) weight
tree; its detector does not run. A file of its own, so that the suite's
workers spread the two golden files.
"""

import pytest
import torch

from watsor_tpu.testing import golden
from tests.test_torch_golden import (golden_problems, golden_tree,  # noqa
                                     photos, port_records)


@pytest.mark.parametrize('family', [f for f in golden.GOLDEN_FAMILIES
                                    if f.startswith('efficientdet_')])
def test_f32_effdet_matches_the_stored_goldens(family, photos):  # noqa: F811
    records = port_records(golden_tree(family), photos, torch.float32,
                           family)
    problems = golden_problems(family, records, photos[1])
    assert not problems, '\n'.join(problems)
