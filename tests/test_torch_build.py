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
        "flash_bwd_dkv": 0, "paged_attention": 2, "quant_int8": 0,
        "dequant_int8": 0, "dqmm": 0,
    }
    _build.reset_launch_counts()
    assert set(_build.launch_counts().values()) == {0}


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
