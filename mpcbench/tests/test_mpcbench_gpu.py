"""The benchmark's cells on the card, briefly: each comes out correct, its
control does not, and the traced run reads every per-layer metric the
cell lists. Skipped without CUDA (decided in the fixture).

Run on the card: ``python -m pytest -m gpu mpcbench/tests -q``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from mpcbench import harness  # noqa: E402

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    r = harness.run_cell(cell, 2**33 + 17, 2.0, False)
    assert r["correct"], r["checked"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    names = {m["name"] for m in harness.cell_metrics(BENCHMARK, cell, "end_to_end")}
    assert set(r["metrics"]) == names
    ctl = harness.run_cell(cell, 2**33 + 18, 2.0, False, control=True)
    assert not ctl["correct"], ctl["checked"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_on_the_card(card, cell):
    r = harness.run_cell(cell, 2**33 + 19, 2.0, True)
    assert r["correct"], r["checked"]
    names = {m["name"] for m in harness.cell_metrics(BENCHMARK, cell, "per_layer")}
    assert set(r["metrics"]) == names
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    for name, m in r["metrics"].items():
        if "_roofline" in name:
            assert 0 < m["value"] <= 100
