"""The granite-4.0-h-micro configuration (``model_type``
``granitemoehybrid``): a tiny cell of it added as files, its checked
protocol steps in the port against the plain reference on the CPU, its
and its model FLOPs by hand."""
from __future__ import annotations

import json
import shutil

import pytest
import torch

from bench import compare, run as bench_run, spec
from bench.reference import granitemoehybrid as gmh
from bench.reference import protocol as ref

from conftest import make_root, tiny_cell

#: the port's reduced sibling (``HybridStackConfig.reduced``) as a
#: configuration file: Mamba2, attention, Mamba2; the reference's SSD in
#: chunks of 16, so 64 tokens cross four
TINY_GRANITE = {
    "model_type": "granitemoehybrid", "hidden_size": 128,
    "intermediate_size": 256, "shared_intermediate_size": 256,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "num_hidden_layers": 3, "vocab_size": 512, "rms_norm_eps": 1e-05,
    "tie_word_embeddings": True,
    "layer_types": ["mamba", "attention", "mamba"], "mamba_n_heads": 16,
    "mamba_d_head": 16, "mamba_d_state": 16, "mamba_d_conv": 4,
    "mamba_expand": 2, "mamba_n_groups": 1, "mamba_chunk_size": 16,
    "num_local_experts": 0, "position_embedding_type": "nope",
    "embedding_multiplier": 12.0, "residual_multiplier": 0.22,
    "attention_multiplier": 0.015625, "logits_scaling": 8.0,
    "param_dtype": "float32", "act_dtype": "bfloat16",
    "port": {"arch": "granite-4.0-h-micro", "reduced": True}}


def _granite_root(tmp, config, traffic=None):
    """:func:`conftest.make_root` with a tiny granite cell added as files."""
    root = make_root(tmp, traffic=traffic)
    bench = root / "bench"
    (bench / "configs" / "tiny-granite.json").write_text(json.dumps(config))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny-granite", "source": "test",
                           "file": "bench/configs/tiny-granite.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "tiny-granite", "config": "tiny-granite",
                             "traffic": "tiny-mix", "chips": 1,
                             "why": "test"})
    for m in doc["per_layer"]:
        m.setdefault("workloads", []).append("tiny-granite")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    shutil.copy(spec.BENCH / "limits" / "granite-h-4k.json",
                bench / "limits" / "tiny-granite.json")
    return tiny_cell(root, "tiny-granite")


def test_reference_follows_the_port(tmp_path):
    """The checked protocol steps (ALIE, MDA, the last one gathering) of
    the port with float32 activations against the reference. The learning
    rate is 100 times the mix's: the first reading is each replica's move
    over the learning rate, and at 0.002 a float32 ``dt_bias`` of -4.6
    (ulp 4.8e-7) does not move at all under its ~1e-4 gradient."""
    cell = _granite_root(tmp_path, {**TINY_GRANITE, "act_dtype": "float32"},
                         traffic={"lr": 0.2})
    cpu = torch.device("cpu")
    prog, _, batches, got = bench_run.checked_steps(cell, 2**31 + 7, cpu)
    assert len(batches) == 2 and prog.state.t == 5
    assert prog.state.params.dtype == torch.float32
    assert prog.bundle.cfg.act_dtype == "float32"
    assert prog.bundle.cfg.family == "granite_hybrid"
    want = bench_run.reference(cell, 2**31 + 7, cpu, batches, got["picks"])
    numbers = compare.gaps(got, want, cell.limits)
    assert numbers["loss_gap"] < 1e-5, numbers
    assert numbers["grad_gap"] < 2e-3, numbers
    assert numbers["change_gap"] < 5e-4, numbers
    assert numbers["select_gap"] == 0.0 and want["other_picks"] == 0
    assert want["losses"].shape == (2, 4)
    assert len({round(x, 6) for x in want["losses"][:, 0]}) == 2


def test_model_flops_and_attention_calls_by_hand():
    c = TINY_GRANITE
    mult = (3 * 3 * 128 * 256                       # the MLPs
            + 2 * 128 * 64 + 2 * 128 * 128          # attention
            + 2 * (128 * (2 * 256 + 2 * 16 + 16)    # in_proj
                   + 4 * 288 + 256 * 128)           # conv, out_proj
            + 512 * 128)                            # the tied head
    attn = 12 * 32 * (64 * 65 // 2) * 4 * 1 * 4
    ssd = 12 * 16 * 16 * 16 * 2 * 4 * 64
    assert gmh.model_flops(c, 4, 64) == 6.0 * mult * 4 * 64 + attn + ssd
    assert gmh.attention_calls(c, 4, 64) == [
        dict(B=4, Sq=64, Skv=64, H=4, kvH=2, hd=32)]


def test_the_cell_and_its_configuration():
    cell = spec.load_cell("granite-h-4k")
    c = cell.config
    assert c["port"] == {"arch": "granite-4.0-h-micro", "depth": 10}
    assert sum(n for *_, n in ref.spans(c)) == 951_991_232
    assert gmh.dims(c)["kinds"] == ["mamba"] * 5 + ["attention"] + \
        ["mamba"] * 4
    assert len(c["layer_types"]) == c["published"]["num_hidden_layers"]
    assert {"attn_roofline", "mfu", "protocol_ms_per_step",
            "peak_mem_gb"} <= set(cell.layers)
    assert gmh.attention_calls(c, 4, 4096) == [
        dict(B=4, Sq=4096, Skv=4096, H=32, kvH=8, hd=64)]

