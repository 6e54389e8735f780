"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark``): the marker of tests that need the card, which skip here,
decided inside each test."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (the H100); skips without one")
