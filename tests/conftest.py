import os
import sys

# single real device for tests/benches (dry-run sets its own flag)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:  # hypothesis is optional — plain pytest runs without it
    from hypothesis import settings  # noqa: E402
except ImportError:
    settings = None
    # ... except in CI, where a missing install would silently skip every
    # property suite (batch assembly, AWD, queueing invariants).  Fail
    # loudly instead: ci.yml pins `hypothesis` in the install step.
    if os.environ.get("CI"):
        raise RuntimeError(
            "hypothesis is not installed but CI=1 — the property-based "
            "suites would silently skip; add `hypothesis` to the CI "
            "install (see .github/workflows/ci.yml)")
else:
    settings.register_profile("ci", max_examples=25, deadline=None)
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips inside the test without one)")
