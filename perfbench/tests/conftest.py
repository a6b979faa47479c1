"""Shared fixtures of the benchmark's own tests: the cells of
BENCHMARK.json cut to a size a CPU runs in seconds."""

import copy
import time

import pytest
import torch

from perfbench import harness, spec

TINY_GRAPH = {"num_nodes": 300, "avg_degree": 4.0, "in_dim": 16,
              "num_classes": 5, "n_train": 150, "n_val": 50, "n_test": 50}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch finds none")


def tiny_cell(name: str):
    """``name``'s cell with Reddit cut to 300 nodes of 16 features and the
    hidden widths to 8, its serve rate to 100 queries/s."""
    c = copy.deepcopy(spec.cell(name))
    c.config["graph"].update(TINY_GRAPH)
    c.config["layers"] = [16, 8, 5]
    if c.traffic["kind"] == "serve":
        c.traffic["qps"] = 100
    return c


def run_tiny(cell, seed=2 ** 31 + 7, seconds=1.0):
    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(),
                            torch.device("cpu"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
