"""Set-up for a pytest run that collects `tests/`.

The JAX package's native loader (`spnet_tpu/native/io.py`) builds its
library with `make` in place the first time `available()` is asked, and
remembers a failure for the rest of the process.  `tests/test_native_io.py`
asks at collection, so test workers that collected at once raced to build
the library, and those that lost skipped the module.  Here every process
of a run that collects `tests/` takes a file lock and asks once, before
collection: one process builds, the others wait and then load the finished
library.  Where no compiler exists the build fails and those tests skip, as
before.  A run of the benchmark's tests alone (`perfbench/tests`) does none
of this, so it never imports the JAX package.
"""

import fcntl
import os

TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
LOCK = os.path.join(TESTS, ".jax_native_build.lock")


def _collects_tests(config) -> bool:
    """Whether a path the run was given is `tests/`, lies in it, or holds
    it."""
    for arg in config.args:
        path = os.path.abspath(os.path.join(
            str(config.invocation_params.dir), str(arg).split("::")[0]))
        if os.path.commonpath([path, TESTS]) in (path, TESTS):
            return True
    return False


def pytest_configure(config):
    if not _collects_tests(config):
        return
    with open(LOCK, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        from spnet_tpu.native import io

        io.available()
