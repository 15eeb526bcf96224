"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's on the CPU: parameter counts and model FLOPs from shapes only
for every architecture and shape cell, and ``tests/test_roofline.py``'s
cases on the H100's published peaks."""
import json

import pytest

from repro.launch import roofline as jroof
from repro.models.registry import ARCH_IDS
from repro_torch.configs.shapes import SHAPE_ORDER, SHAPES
from repro_torch.launch import roofline


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_equal_the_reference(arch):
    assert roofline.param_counts(arch) == jroof.param_counts(arch)
    for shape in SHAPE_ORDER:
        assert roofline.model_flops(arch, shape) == \
            jroof.model_flops(arch, shape)


def test_h100_peaks():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9


@pytest.fixture(scope="module")
def whisper_counts():
    return roofline.param_counts("whisper-small")


def test_param_counts_dense_arch(whisper_counts):
    total, active = whisper_counts
    # whisper-small is dense: every parameter is active
    assert total == active
    # ~88M headline params; the reproduction's count must be in range
    assert 5e7 < total < 3e8


def test_model_flops_accounting(whisper_counts):
    _, n_active = whisper_counts
    cell = SHAPES["train_4k"]
    train = roofline.model_flops("whisper-small", "train_4k")
    assert train == 6.0 * n_active * cell.global_batch * cell.seq_len
    # decode counts one token per sequence
    dcell = SHAPES["decode_32k"]
    decode = roofline.model_flops("whisper-small", "decode_32k")
    assert decode == 2.0 * n_active * dcell.global_batch
    prefill = roofline.model_flops("whisper-small", "prefill_32k")
    assert prefill > decode


def test_roofline_row_and_table_from_artifact(tmp_path, monkeypatch):
    mesh_dir = tmp_path / "16x16"
    mesh_dir.mkdir()
    artifact = {
        "kind": "train",
        "n_devices": 256,
        "n_groups": 4,
        "extrapolated": {
            "flops": 2.0e12,
            "bytes_accessed": 1.0e13,          # memory term dominates
            "collective_bytes_per_device": 5.0e9,
        },
        "gather": {
            "flops": 1.0e10,
            "bytes_accessed": 1.0e10,
            "collective_bytes_per_device": 1.0e9,
        },
        "full": {"memory": {"argument_bytes": 8 * 2**30,
                            "temp_bytes": 2 * 2**30,
                            "output_bytes": 1 * 2**30,
                            "alias_bytes": 1 * 2**30}},
    }
    with open(mesh_dir / "whisper-small__train_4k__naive.json", "w") as f:
        json.dump(artifact, f)
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path))

    row = roofline.roofline_row("whisper-small", "train_4k")
    assert row["dominant"] == "memory"
    assert row["t_memory_s"] == pytest.approx(
        1.0e13 / roofline.HBM_BW + 1.0e10 / roofline.HBM_BW / 50)
    assert row["t_collective_s"] == pytest.approx(
        5.0e9 / roofline.LINK_BW + 1.0e9 / roofline.LINK_BW / 50)
    assert row["est_step_s"] == pytest.approx(row["t_memory_s"])
    assert 0 < row["roofline_fraction"] < 1
    assert row["mem_per_dev_gib"] == pytest.approx(10.0)
    assert row["fits"]
    assert row["lever"]                      # every cell names its lever
    assert "Pallas" not in row["lever"] and "VMEM" not in row["lever"]

    # missing cells render as SKIP rows, present cells render with terms
    skip = roofline.roofline_row("whisper-small", "decode_32k")
    assert skip["skipped"] == "missing"
    table = roofline.format_table([row, skip])
    assert "whisper-small" in table and "SKIP" in table
    assert "memory" in table
    assert "reckoned from the dry run, H100 SXM published peaks" in table


def test_load_cell_missing_is_none(tmp_path, monkeypatch):
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path))
    assert roofline.load_cell("whisper-small", "train_4k") is None
