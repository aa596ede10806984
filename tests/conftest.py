"""Test env: an 8-device CPU JAX (a virtual multi-device mesh, per
SURVEY.md §4: multi-host tests on CPU with
xla_force_host_platform_device_count), whatever accelerator the machine
has.  The persistent compilation cache stays off, so tests write
nothing into the checkout.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

assert jax.default_backend() == "cpu", jax.default_backend()
assert len(jax.devices()) >= 8, jax.devices()

import pytest  # noqa: E402


# The exactness-contract corpus (md5 of the sorted gapped dump:
# 1a4ca1e7d4f2e70253aadca10d8351b4, SURVEY.md §0) is vendored so the
# parity tests can never silently skip (VERDICT r1).  When the upstream
# reference checkout is present, assert the vendored copy is byte-exact.
VENDORED_SAMPLE = os.path.join(os.path.dirname(__file__), "data", "sample.fasta")
REFERENCE_SAMPLE = "/root/reference/k-mer-count/sample.fasta"


@pytest.fixture(scope="session")
def sample_fasta_path():
    assert os.path.exists(VENDORED_SAMPLE), "vendored fixture missing"
    if os.path.exists(REFERENCE_SAMPLE):
        with open(VENDORED_SAMPLE, "rb") as a, open(REFERENCE_SAMPLE, "rb") as b:
            assert a.read() == b.read(), \
                "vendored sample.fasta diverged from the reference corpus"
    return VENDORED_SAMPLE
