"""Root pytest hook: build the JAX package's native library once, before
the parallel test workers start.

`plvs_tpu.native` compiles `_plvs_native_<tag>.so` with g++ on first use,
and every process writes the same temporary file before renaming it. With
pytest-xdist, all workers import `tests/test_native.py` at once, start that
build together, and a worker that loses the race caches the error and skips
the native tests for its whole life. Building it here, on the controller
and under the lock file that `tests/test_torch_place_recognition.py`'s
`_need_native` waits on, leaves the workers a finished library to load.

This file imports no jax: `tests/conftest.py` sets `XLA_FLAGS` before the
first jax import. It never raises and never skips: without g++ or libpng
the native tests report their own skip reason, as before.
"""

import fcntl
import os
import tempfile


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    try:
        from plvs_tpu import native
        lock_path = os.path.join(tempfile.gettempdir(),
                                 "plvs_native_load.lock")
        with open(lock_path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                native.available()
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    except Exception:
        pass
