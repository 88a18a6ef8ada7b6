"""pytest settings of the benchmark's own tests (``pytest portbench/``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; skips with its reason elsewhere")
