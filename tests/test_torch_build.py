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


def test_shared_header_rebuilds_both_flash_libraries(tmp_path, monkeypatch):
    """The forward and the backward include the same tile header: editing
    it (or the sm90 header under it) renames both libraries."""
    import shutil
    csrc = _build.SOURCES["flash_attention"].parent
    assert _build.SOURCES["flash_attention_bwd"].parent == csrc
    for src in ("flash_fwd.cu", "flash_bwd.cu"):
        assert '#include "tiles.cuh"' in (csrc / src).read_text()
    copy = tmp_path / "csrc"
    shutil.copytree(csrc, copy)
    monkeypatch.setattr(_build, "SOURCES", {
        "flash_attention": copy / "flash_fwd.cu",
        "flash_attention_bwd": copy / "flash_bwd.cu"})
    names = ("flash_attention", "flash_attention_bwd")
    seen = [tuple(_build.lib_path(n) for n in names)]
    for header in ("tiles.cuh", "sm90.cuh"):
        with open(copy / header, "a") as f:
            f.write("\n// edited\n")
        paths = tuple(_build.lib_path(n) for n in names)
        assert all(p not in {q[i] for q in seen} for i, p in enumerate(paths))
        seen.append(paths)


def test_ptxas_usage_reads_registers_and_spill_per_kernel():
    """``ptxas -v``'s report, as ``build`` returns it, per kernel."""
    report = "\n".join([
        "ptxas info    : Compiling entry function '_Z3fwdv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3fwdv",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z4gramv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z4gramv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 480 bytes smem"])
    assert _build.ptxas_usage(report) == {"_Z3fwdv": (168, 8, 4),
                                          "_Z4gramv": (64, 0, 0)}
    assert _build.ptxas_usage("") == {}
