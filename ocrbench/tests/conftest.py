"""The benchmark's own tests (CPU). Tests that need the card decide so
inside the `cuda` fixture."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny(cell, lines=(8, 12)):
    """The cell at a size the CPU runs in seconds: 600 × 840 pages at 90
    dpi (det limit 640), three in the pool and in flight."""
    t = cell.traffic
    if t["kind"] == "pages":
        t["page"] = {"width": 600, "height": 840, "dpi": 90}
        t["lines"] = list(lines)
        t["program"]["det_limit_side_len"] = 640
    else:
        t["per_request"] = 4
        t["chars"] = [4, 12]
    t["pool"] = 3
    t["load"]["in_flight"] = 3
    t["check"] = {"requests": 2, "from_first": 2}
    return cell
