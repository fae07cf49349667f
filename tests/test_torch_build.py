"""The port's kernel build helper (dlrover_tpu_torch/ops/_build.py):
source-hash keyed library names, a missing nvcc refused with a clear
error, launch errors raised, and the launch counters. Nothing here
compiles (there is no nvcc on a CPU-only machine)."""

import pytest

from dlrover_tpu_torch.ops import _build


def test_every_kernel_has_a_source():
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()


def test_library_path_follows_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path("k")
    assert first.parent == tmp_path / "_build"
    assert first == _build.library_path("k")        # stable
    src.write_text("// two\n")
    assert _build.library_path("k") != first         # edited -> rebuild
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    src.write_text("// one\n")
    assert _build.library_path("k") != first         # flags -> rebuild


def test_library_path_follows_the_included_headers(tmp_path, monkeypatch):
    """A shared header (`csrc/*.cuh`) is hashed into the name of every
    library whose source includes it, directly or through another
    header, and into no other: an edited header rebuilds exactly the
    libraries that include it."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "base.cuh").write_text("// base one\n")
    (tmp_path / "mid.cuh").write_text('#pragma once\n#include "base.cuh"\n')
    (tmp_path / "a.cu").write_text('#include <stdint.h>\n#include "mid.cuh"\n')
    (tmp_path / "b.cu").write_text('  #  include "base.cuh"\n')
    (tmp_path / "c.cu").write_text("#include <cuda_runtime.h>\n")
    first = {n: _build.library_path(n) for n in "abc"}
    (tmp_path / "base.cuh").write_text("// base two\n")
    second = {n: _build.library_path(n) for n in "abc"}
    assert second["a"] != first["a"] and second["b"] != first["b"]
    assert second["c"] == first["c"]
    (tmp_path / "mid.cuh").write_text('#include "base.cuh"\n// edited\n')
    third = {n: _build.library_path(n) for n in "abc"}
    assert third["a"] != second["a"]
    assert third["b"] == second["b"] and third["c"] == second["c"]


def test_the_attention_sources_share_the_hopper_header():
    """Both flash sources take their TMA, mbarrier and wgmma pieces from
    csrc/hopper.cuh, so its bytes are part of both library names."""
    for name in ("flash_fwd", "flash_bwd"):
        found = [p.name for p in _build._sources(_build.CSRC / f"{name}.cu")]
        assert found == [f"{name}.cu", "hopper.cuh"]


def test_dqmm_shares_the_hopper_header():
    """The dequant-matmul takes its TMA, mbarrier and wgmma pieces from
    csrc/hopper.cuh too, so an edited header rebuilds it as well."""
    found = [p.name for p in _build._sources(_build.CSRC / "dqmm.cu")]
    assert found == ["dqmm.cu", "hopper.cuh"]


def test_missing_nvcc_is_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_check_raises_on_cuda_error():
    _build.check(0, "flash_fwd")
    with pytest.raises(RuntimeError, match="flash_fwd.*CUDA error 9"):
        _build.check(9, "flash_fwd", "q(1, 16, 4, 32)")


def test_launch_counters():
    _build.reset_launch_counts()
    _build.count_launch("paged_attention")
    _build.count_launch("paged_attention")
    assert _build.launch_counts() == {
        "flash_fwd": 0, "flash_fwd_wgmma": 0, "flash_bwd_dq": 0,
        "flash_bwd_dq_wgmma": 0, "flash_bwd_dkv": 0,
        "flash_bwd_dkv_wgmma": 0, "paged_attention": 2,
        "paged_attention_tma": 0, "paged_attention_tma_int8": 0,
        "quant_int8": 0, "quant_int8_any": 0,
        "dequant_int8": 0, "dequant_int8_any": 0,
        "dqmm": 0, "dqmm_ws": 0, "dqmm_decode_tma": 0, "dqmm_general": 0,
    }
    _build.reset_launch_counts()
    assert set(_build.launch_counts().values()) == {0}


def test_launch_counters_across_threads():
    """Launches from several threads at once all reach the global count,
    and each thread's own view counts only its launches (what
    chip_smoke's serve.fleet reads around each engine's step)."""
    import threading

    _build.reset_launch_counts()
    mine = _build.thread_launch_counts()["flash_fwd"]
    views = {}

    def launch(i):
        before = _build.thread_launch_counts()["flash_fwd"]
        for _ in range(1000 * (i + 1)):
            _build.count_launch("flash_fwd")
        views[i] = _build.thread_launch_counts()["flash_fwd"] - before

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert views == {0: 1000, 1: 2000, 2: 3000, 3: 4000}
    assert _build.launch_counts()["flash_fwd"] == 10000
    assert _build.thread_launch_counts()["flash_fwd"] == mine
    _build.reset_launch_counts()


def test_function_sets_types_once(monkeypatch):
    """`function` binds a symbol of a kernel library with int return and
    the given argument types, once: later calls get the same object."""
    import ctypes

    libc = ctypes.CDLL(None)
    monkeypatch.setattr(_build, "load", lambda name: libc)
    monkeypatch.setattr(_build, "_FNS", {})
    fn = _build.function("libc", "abs", [ctypes.c_int])
    assert fn(-7) == 7
    assert fn.restype is ctypes.c_int and fn.argtypes == [ctypes.c_int]
    assert _build.function("libc", "abs", [ctypes.c_int]) is fn
