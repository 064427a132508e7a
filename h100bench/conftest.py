"""pytest settings of the benchmark's own tests (h100bench/tests/):
the `cuda` marker, for the tests that need an NVIDIA GPU.  Each such test
looks for the card inside itself and skips without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips on a machine without "
        "one")
