import jax
import pytest

# Smoke tests and benches must see the single real CPU device; ONLY the
# dry-run subprocesses set xla_force_host_platform_device_count.
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running (minutes on CPU); excluded from the CI gate "
        "via -m 'not slow', still part of the full tier-1 run")
    config.addinivalue_line(
        "markers",
        "cuda: runs the port's CUDA kernels, so it needs an NVIDIA card and "
        "nvcc; skips elsewhere (on the card, which has no JAX: "
        "PYTHONPATH=src python -m pytest --noconftest -o markers=cuda "
        "tests/test_torch_cuda.py)")


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)
