"""__graft_entry__ must work in-process: entry() compiles, and
dryrun_multichip runs on the CPU mesh without opening an accelerator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as ge


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_dryrun_multichip_in_process():
    # conftest already pins the CPU backend with 8 virtual devices — the
    # same environment the driver provides; the dry-run must complete.
    ge.dryrun_multichip(8)


def test_entry_compile_check():
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (4, 4)
    assert np.isfinite(np.asarray(out)).all()


def test_pin_cpu_backend_idempotent():
    ge._pin_cpu_backend(8)
    assert jax.default_backend() == "cpu"
    assert len(jax.devices()) >= 8


def test_backend_detection_under_conftest():
    # conftest pre-pins cpu with 8 devices, so the in-process path is
    # viable and the subprocess fallback must NOT be chosen.
    jnp.zeros(1).block_until_ready()
    assert not ge._backend_already_non_cpu(8)
    # with an unreachable device count the fallback must trigger
    assert ge._backend_already_non_cpu(10**6)
