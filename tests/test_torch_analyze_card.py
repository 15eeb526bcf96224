"""``python -m repro_torch.analyze --card`` on the card: layer 3 on the
``smoke`` preset leaves no finding that is neither baselined nor
suppressed, and its counts are whole. Imports no JAX, so it runs on a
machine with a GPU and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_analyze_card.py

Every test skips where CUDA is absent.
"""
import os

import pytest

from _torch_parity import require_cuda
from repro_torch.analyze import card, findings

pytestmark = pytest.mark.cuda

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_card_layer_is_clean_modulo_the_baseline():
    dev = require_cuda()
    stats = card.measure(dev)
    assert set(stats) == {"fused", "protocol[naive]", "protocol[sharded]",
                          "serve"}
    for label, s in stats.items():
        if label != "serve":
            assert s["dtoh_per_run"] >= 1, label    # the metric buffers
    base = findings.load_baseline(os.path.join(ROOT, findings.BASELINE_PATH))
    new, _ = findings.split_baselined(card.findings(stats), base)
    assert new == [], [f.format() for f in new]
