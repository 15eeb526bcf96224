"""The plain reference: its WKV scan against the step-by-step recurrence,
its attention against the softmax written out, and its protocol steps
against the port's for several steps of both families' reduced
configurations on the CPU (the port's activations in float32 there, so
that the two agree to float32's rounding)."""
from __future__ import annotations

import math

import pytest
import torch

from bench import compare, run as bench_run
from bench.reference import phi3, rwkv6

from conftest import TINY, make_root, tiny_cell


def _recurrence(r, k, v, w, u):
    """y_t = r_t . (S + diag(u k_t) v_t), S <- diag(exp w_t) S + k_t v_t."""
    S, H, K = r.shape
    state = torch.zeros(H, K, K, dtype=r.dtype)
    ys = []
    for t in range(S):
        kv = k[t][:, :, None] * v[t][:, None, :]
        ys.append(torch.einsum("hk,hkv->hv", r[t],
                               state + u[:, :, None] * kv))
        state = torch.exp(w[t])[:, :, None] * state + kv
    return torch.stack(ys)


@pytest.mark.parametrize("S", [1, 31, 32, 70])
def test_wkv_chunks_equal_the_recurrence(S):
    g = torch.Generator().manual_seed(S)
    B, H, K = 2, 3, 8
    r, k, v = (torch.randn(B, S, H, K, generator=g, dtype=torch.float64)
               for _ in range(3))
    w = -torch.exp(torch.randn(B, S, H, K, generator=g, dtype=torch.float64))
    w = torch.clamp(w, min=rwkv6.LOG_DECAY_FLOOR)
    u = 0.1 * torch.randn(H, K, generator=g, dtype=torch.float64)
    want = torch.stack([_recurrence(r[b], k[b], v[b], w[b], u)
                        for b in range(B)])
    torch.testing.assert_close(rwkv6.wkv(r, k, v, w, u), want)


def test_attention_block_equals_softmax_written_out():
    c = TINY["tiny-dense"]
    d = phi3.dims(c)
    g = torch.Generator().manual_seed(0)
    p = {path: 0.1 * torch.randn(shape, generator=g, dtype=torch.float64)
         for path, shape, _, _ in phi3.leaf_table(c)}
    S = 5
    x = torch.randn(S, d["D"], generator=g, dtype=torch.float64)
    cos, sin = torch.ones(S, 1, d["hd"] // 2), torch.zeros(S, 1, d["hd"] // 2)
    got = phi3._block(x[None], p, 0, d, cos.double(), sin.double())[0]
    # the same block, one query at a time
    h = phi3._rmsnorm(x, p["blocks/ln_attn/scale"][0], d["eps"])
    q = (h @ p["blocks/attn/wq"][0]).view(S, d["H"], d["hd"])
    k = (h @ p["blocks/attn/wk"][0]).view(S, d["kvH"], d["hd"])
    v = (h @ p["blocks/attn/wv"][0]).view(S, d["kvH"], d["hd"])
    rows = []
    for t in range(S):
        heads = []
        for j in range(d["H"]):
            kv = j // (d["H"] // d["kvH"])
            s = k[:t + 1, kv] @ q[t, j] / math.sqrt(d["hd"])
            heads.append(torch.softmax(s, 0) @ v[:t + 1, kv])
        rows.append(torch.cat(heads))
    x2 = x + torch.stack(rows) @ p["blocks/attn/wo"][0]
    h2 = phi3._rmsnorm(x2, p["blocks/ln_mlp/scale"][0], d["eps"])
    want = x2 + (torch.nn.functional.silu(h2 @ p["blocks/mlp/w_gate"][0])
                 * (h2 @ p["blocks/mlp/w_up"][0])) @ p["blocks/mlp/w_down"][0]
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_follows_the_port(tmp_path, name, monkeypatch):
    """The checked protocol steps (ALIE, MDA, the last one gathering) of
    the port with float32 activations against the reference."""
    monkeypatch.setitem(TINY[name], "act_dtype", "float32")
    cell = tiny_cell(make_root(tmp_path), name)
    cpu = torch.device("cpu")
    prog, _, batches, got = bench_run.checked_steps(cell, 2**31 + 7, cpu)
    assert len(batches) == 2 and prog.state.t == 5
    # the precision is the configuration file's
    assert prog.state.params.dtype == torch.float32
    assert prog.bundle.cfg.act_dtype == "float32"
    want = bench_run.reference(cell, 2**31 + 7, cpu, batches, got["picks"])
    numbers = compare.gaps(got, want, cell.limits)
    assert numbers["loss_gap"] < 1e-5, numbers
    assert numbers["grad_gap"] < 2e-3, numbers
    assert numbers["change_gap"] < 5e-4, numbers
    assert numbers["select_gap"] == 0.0 and want["other_picks"] == 0
    # the losses move, so the comparison reads distinct steps
    assert want["losses"].shape == (2, 4)
    assert len({round(x, 6) for x in want["losses"][:, 0]}) == 2
