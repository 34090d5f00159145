import os

import pytest

# persistent XLA compilation cache: the suite is compile-bound on CPU, so
# repeat runs (local dev loops, warm CI caches) skip most of the work.
# Opt out with JAX_COMPILATION_CACHE_DIR="".
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      "/tmp/pipo_jax_compile_cache")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked slow (model-smoke matrix, "
                          "subprocess/e2e, sweeps)")


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "slow: long-running (subprocess / e2e) tests")
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card (skips without one)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow test: pass --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(autouse=True)
def _fresh_deprecation_warnings():
    """Deprecation warnings are deduped once per process
    (``warn_deprecated_once``); reset the dedup set per TEST so every
    test observes the warnings its own calls trigger, regardless of
    which test touched the legacy path first."""
    from repro.serving.spec import reset_deprecation_warnings
    reset_deprecation_warnings()
    yield
