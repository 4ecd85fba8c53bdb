"""Start-up plumbing: where the compile cache lives, and the native
library built from the source it is loaded for."""
import ctypes
import os
import re
import shutil

import jax
import pytest

from metacache_tpu import native
from metacache_tpu.utils import compile_cache


@pytest.mark.parametrize("env_dir", [None, "custom"], ids=["default", "env"])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(compile_cache.CHECKOUT_DIR, ".jax_cache")
            assert compile_cache.configure_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
        else:
            want = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
            jax.config.update("jax_compilation_cache_dir", before)
            assert compile_cache.configure_compile_cache() == want
            # JAX reads the variable itself; nothing is set in code
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_library_built_from_source_under_hashed_name(tmp_path,
                                                            monkeypatch):
    src = tmp_path / "mcio.cpp"
    shutil.copy(native._SRC, src)
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    # a binary of unknown origin under the old fixed name is never loaded
    (tmp_path / "libmcio.so").write_bytes(b"not a library")
    path = native.library_path()
    assert re.fullmatch(r"libmcio-[0-9a-f]{16}\.so", os.path.basename(path))
    assert not os.path.exists(path)
    assert native._compile(path)
    lib = ctypes.CDLL(path)
    assert hasattr(lib, "mcio_open")
    with open(src, "a") as f:
        f.write("\n// changed\n")
    assert native.library_path() != path
