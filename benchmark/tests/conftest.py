"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from
the checkout's root. Tests marked ``card`` need a CUDA card and skip
without one (each decides inside the test); run them on the card with
``python -m pytest benchmark/tests -q -m card``."""

import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def pytest_sessionstart(session):
    torch.set_num_threads(4)
