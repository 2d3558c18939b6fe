"""One JAX persistent compilation cache for the port's test files of a run.

Most of the time of a port test that holds the port against the JAX
package is the JAX side's compile of the same few programs (the engine
round, flush and sweep at the test geometries), repeated by each pytest
worker that collects a file needing them. A port test file imports
:func:`shared_jax_compile_cache`; while that file's tests run, the JAX
package compiles through a persistent cache in one directory that every
worker of the same run shares (``PYTEST_XDIST_TESTRUNUID``; a run without
xdist gets a directory of its own process), so each program compiles once
a run. Entries go through the cache's file lock (a size limit turns it
on), so no worker reads another's half-written entry. When the file's
tests end, the cache is switched off again: the JAX package's own test
files compile as they always did. Directories of runs older than a day
are removed.

The same fixture compiles those programs with
``jax_disable_most_optimizations`` (XLA:CPU at optimization level 0,
without LLVM's expensive passes): the same programs, less codegen work.
The port's tests compare integer states and responses, which are exact
at any optimization level.

While the file's tests run, PyTorch also uses one intra-op CPU thread
(``tests/_torch_threads.py`` says why), restored when the file ends.
"""

import os
import shutil
import tempfile
import time

import jax
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache as _cc

_PREFIX = "grapevine-torch-jax-cache-"
#: the cache's size limit (it also turns on its file lock)
_MAX_BYTES = 32 << 30


def _run_dir() -> str:
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID") or f"pid{os.getpid()}"
    root = tempfile.gettempdir()
    path = os.path.join(root, _PREFIX + run)
    if not os.path.isdir(path):
        for name in os.listdir(root):
            old = os.path.join(root, name)
            try:
                if name.startswith(_PREFIX) and time.time() - os.path.getmtime(old) > 86400:
                    shutil.rmtree(old, ignore_errors=True)
            except OSError:
                pass
        os.makedirs(path, exist_ok=True)
    return path


#: the settings a port test file's tests run under, and their values
_SETTINGS = ("jax_compilation_cache_dir", "jax_compilation_cache_max_size",
             "jax_disable_most_optimizations")


@pytest.fixture(scope="module", autouse=True)
def shared_jax_compile_cache():
    before = {k: jax.config.values[k] for k in _SETTINGS}
    jax.config.update("jax_compilation_cache_dir", _run_dir())
    jax.config.update("jax_compilation_cache_max_size", _MAX_BYTES)
    jax.config.update("jax_disable_most_optimizations", True)
    _cc.reset_cache()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
        _cc.reset_cache()
        torch.set_num_threads(threads)
