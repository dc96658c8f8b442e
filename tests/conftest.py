import os
import sys
import types

# tests run on the single real CPU device — the 512-device fake platform is
# exclusively the dry-run's business (see launch/dryrun.py)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import pytest  # noqa: E402

try:
    from hypothesis import settings  # noqa: E402

    settings.register_profile("ci", max_examples=25, deadline=None)
    settings.load_profile("ci")
except ModuleNotFoundError:
    # Degrade gracefully: property tests skip instead of killing collection.
    # Test modules do `from hypothesis import given, strategies as st` at
    # import time, so a stub module must be in sys.modules before they load.

    class _AnyStrategy:
        """Stands in for any strategy constructor/combinator at collect time."""

        def __getattr__(self, name):
            return self

        def __call__(self, *args, **kwargs):
            return self

    def _given(*args, **kwargs):
        return pytest.mark.skip(reason="hypothesis not installed")

    _stub = types.ModuleType("hypothesis")
    _stub.given = _given
    _stub.settings = _AnyStrategy()
    _stub.strategies = _AnyStrategy()
    sys.modules["hypothesis"] = _stub


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one "
                                       "(decided inside the test)")
