"""The CPU tests' stand-in for the card: a kernel library's host emulation
(``ops/_build.py: host_library``) in place of the CUDA libraries."""

import pytest

from vae_equalizer_tpu_torch.ops import _build


def host_lib(name: str):
    """Library ``name``'s host emulation, typed; skips the test where the host
    has no C++ compiler."""
    try:
        return _build.host_library(name)
    except FileNotFoundError as e:
        pytest.skip(str(e))


def emulate(monkeypatch, lib):
    """``lib`` in place of the card's libraries (``_build.load`` / ``stream``)
    for one test; every wrapper's launch count is restored afterwards (other
    tests of the process read them)."""
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda dev: None)
    for wrapper in _build.COUNTED:
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)
    return lib
