"""GPU test tier: runs on the default JAX backend, which must be a GPU.

Unlike tests/conftest.py this does not force the CPU platform: these tests
compile the Triton kernels for the card and hold them to the XLA engine
and to the host oracles.  Every test carries the ``gpu`` marker; the
``_needs_gpu`` fixture skips them, with the reason, where JAX finds no GPU.

Run on a machine with a card:  python -m pytest tests_gpu -q
(``python chip_smoke.py`` runs this tier too, in its own process.)
"""

import pytest

from mc_tpu.utils.platform import start


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    backend = start()
    if backend != "gpu":
        pytest.skip(f"needs a GPU backend (JAX reports {backend!r})")
