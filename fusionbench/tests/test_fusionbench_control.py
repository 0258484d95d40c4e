"""The control: the reference in TF32 in the program's place fails the
comparison (TF32 exists only on the card, so this runs there)."""

import pytest

from fusionbench import harness

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["hash_vga.orbit", "slam_vga.live_orbit"])
@pytest.mark.parametrize("seed", [11, 2**31 + 5, 123456789])
def test_control_is_not_correct(cell, seed, card):
    out = harness.run(cell, seed, 2.0, False, device="cuda", control=True)
    assert out["correct"], out["checks"]
    limits = {k: c["limit"] for k, c in out["checks"].items()}
    failed = [k for k, c in out["control"].items()
              if isinstance(c["value"], str) or c["value"] > limits[k]]
    assert failed, out["control"]
