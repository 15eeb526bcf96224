"""The kernels' build cache, without building: a library's name follows
every file of its source directory and the flags, so an edited header is
never served from a stale library."""
from repro_torch.kernels import _build


def test_lib_path_follows_headers_and_flags(tmp_path, monkeypatch):
    cu, cuh = tmp_path / "k.cu", tmp_path / "k.cuh"
    cu.write_text('#include "k.cuh"\n')
    cuh.write_text("constexpr int N = 1;\n")
    monkeypatch.setattr(_build, "SOURCES", {"k": cu})
    first = _build.lib_path("k")
    assert first == _build.lib_path("k")
    assert first.parent == _build.BUILD_DIR
    cuh.write_text("constexpr int N = 2;\n")
    second = _build.lib_path("k")
    assert second != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DX",))
    assert _build.lib_path("k") not in (first, second)
