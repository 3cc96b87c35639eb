"""A fixture for the port's test modules that compare with the JAX package:
after a module's tests, collect garbage and hand the C heap's free pages
back to the OS (glibc's ``malloc_trim``), so that a pytest-xdist worker does
not carry the freed heap of every earlier module (JAX compilations, torch
models and batches) into the next: without it most of a worker's resident
memory at the end of a full run is freed heap."""

import ctypes
import gc

import pytest


@pytest.fixture(scope="module", autouse=True)
def release_freed_heap():
    yield
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):   # not glibc: nothing to hand back
        pass
