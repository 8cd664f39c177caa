import os

# Tests run single-device on CPU: the dry-run (and ONLY the dry-run) forces
# 512 placeholder devices, in its own subprocess.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

try:
    from hypothesis import settings
except ImportError:  # property tests skip themselves via tests/_hyp.py
    settings = None

if settings is not None:
    settings.register_profile("repro", deadline=None, max_examples=15)
    settings.load_profile("repro")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips itself on a host without one)"
    )
