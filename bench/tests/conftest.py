"""Fixtures of the benchmark's CPU tests: tiny cells built as files, the
way a later change adds a cell, beside the real ones."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from bench import spec

#: the port's reduced siblings (``ArchConfig.reduced``), as configuration
#: files
TINY = {
    "tiny-dense": {
        "model_type": "phi3", "hidden_size": 128, "intermediate_size": 256,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
        "num_hidden_layers": 2, "vocab_size": 512, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-05, "tie_word_embeddings": True,
        "param_dtype": "float32", "act_dtype": "bfloat16",
        "port": {"arch": "phi4-mini-3.8b", "reduced": True}},
    "tiny-rwkv6": {
        "model_type": "rwkv6", "hidden_size": 128, "head_size": 64,
        "intermediate_size": 256, "num_hidden_layers": 2, "vocab_size": 512,
        "layer_norm_epsilon": 1e-05,
        "param_dtype": "float32", "act_dtype": "bfloat16",
        "port": {"arch": "rwkv6-3b", "reduced": True}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skips itself without one)")


def make_root(tmp: Path, traffic: dict | None = None,
              limits: str = "phi4-1k") -> Path:
    """A checkout-like root in ``tmp``: the real ``BENCHMARK.json`` with
    a tiny cell of each family added (``tiny-dense``, ``tiny-rwkv6``) on a
    tiny mix (``g4-alie-1k`` at 4 x 64 tokens a group, updated by
    ``traffic``), each with the limits of the cell ``limits``, and the
    real metrics' readers."""
    bench = tmp / "bench"
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(spec.BENCH / "metrics", bench / "metrics",
                    dirs_exist_ok=True)
    doc = spec.read_json(spec.ROOT / "BENCHMARK.json")
    mix = spec.read_json(spec.BENCH / "traffic" / "g4-alie-1k.json")
    mix.update({"seq": 64, **(traffic or {})})
    (bench / "traffic" / "tiny-mix.json").write_text(json.dumps(mix))
    for name, cfg in TINY.items():
        path = bench / "configs" / f"{name}.json"
        path.write_text(json.dumps(cfg))
        doc["configs"].append({"name": name, "source": "test",
                               "file": str(path.relative_to(tmp)),
                               "reduced": [], "why": "test"})
        doc["workloads"].append({"name": name, "config": name,
                                 "traffic": "tiny-mix", "chips": 1,
                                 "why": "test"})
        shutil.copy(spec.BENCH / "limits" / f"{limits}.json",
                    bench / "limits" / f"{name}.json")
        for m in doc["per_layer"]:
            m.setdefault("workloads", []).append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


def tiny_cell(root: Path, name: str) -> spec.Cell:
    return spec.load_cell(name, root, root / "bench")
