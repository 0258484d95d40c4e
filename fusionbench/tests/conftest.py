"""Small shapes for the benchmark's CPU tests: the reference's
``tiny_test_config`` and short passes."""

import dataclasses
import json

import pytest


@pytest.fixture(scope="session")
def tiny_overrides():
    from fusionbench.reference import config as rc

    pipeline = json.loads(json.dumps(dataclasses.asdict(rc.tiny_test_config())))

    def make(cell: str) -> dict:
        over = {"config": {"pipeline": pipeline}}
        if "live" not in cell:
            over["traffic"] = {"trajectory": {"frames": 16}}
        return over

    return make


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
