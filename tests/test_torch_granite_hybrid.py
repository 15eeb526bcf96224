"""granite-4.0-h-micro, the port's ``granite_hybrid`` family (Mamba2 and
NoPE attention layers in one stack with muP multipliers), against the
benchmark's plain reference, ``bench/reference/granitemoehybrid.py``, at a
tiny size on the CPU: the loss and every leaf's gradient, prefill and
decode against the full forward's logits, what the SSD's carried state
adds, the reference's chunked scan against the step-by-step recurrence,
and the reference against transformers' ``GraniteMoeHybridForCausalLM``
where that package is installed. Also the flash wrappers' ``scale``
argument, and the arch id's place in the registry and the launchers."""
import dataclasses
import gc
import math

import pytest
import torch

from bench import inputs
from bench.reference import granitemoehybrid as R
from bench.reference import protocol as refp
from repro.models import registry as jregistry
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import granite_hybrid as GH
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import registry

ARCH = "granite-4.0-h-micro"
#: the reduced sibling as a configuration file of the benchmark's (the
#: published keys at the reduced widths), its SSD in chunks of 16
TINY = {
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
    "attention_multiplier": 0.015625, "logits_scaling": 8.0}
CPU = torch.device("cpu")
#: the comparison's tolerances in float32: the loss relative (some ten
#: float32 ulps; the two read equal in float32 on the CPU), each leaf's
#: gradient over its norm (the two sum the SSD in different chunks, 64 and
#: 16, and orders; they part by ~1e-6)
LOSS_TOL, GRAD_TOL = 1e-6, 1e-5


def _bundle():
    b = registry.get_bundle(ARCH, reduced=True)
    b.cfg = dataclasses.replace(b.cfg, act_dtype="float32")
    return b


def _weights(seed):
    """The benchmark's initial model of :data:`TINY`: ``(spans, flat)``."""
    return refp.spans(TINY), inputs.make_weights(TINY, seed, CPU)


def _nested(sp, leaves):
    out = {}
    for (path, *_), leaf in zip(sp, leaves):
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def _leaves(sp, flat):
    return [flat[o:o + n].view(shape).clone().requires_grad_()
            for _, shape, o, n in sp]


def _batch(seed, B=2, S=70):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, TINY["vocab_size"], (B, S), generator=g),
            torch.randint(0, TINY["vocab_size"], (B, S), generator=g))


def test_reduced_sibling_is_the_tiny_configuration():
    """The port's reduced config and :data:`TINY` are one model, and the
    benchmark's flat layout is the port's own."""
    cfg = _bundle().cfg
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab, cfg.n_layers) == (128, 4, 2, 32, 256, 512, 3)
    assert M.dims(cfg) == (256, 16, 16, 16)
    assert list(cfg.layer_types[:3]) == TINY["layer_types"]
    from repro_torch.core.simulator import FlatTree
    tree = FlatTree.from_params(_bundle().meta_params())
    assert [("/".join(p), s) for p, s in zip(tree.paths, tree.shapes)] == [
        (p, tuple(s)) for p, s, _, _ in refp.spans(TINY)]


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_loss_and_every_leaf_gradient_match_the_reference(seed):
    """Float32 activations: the loss and each leaf's gradient within
    :data:`LOSS_TOL` and :data:`GRAD_TOL`."""
    sp, flat = _weights(seed)
    tokens, labels = _batch(seed)
    mine = _leaves(sp, flat)
    loss = _bundle().loss(_nested(sp, mine), {"tokens": tokens,
                                              "labels": labels})
    got = torch.autograd.grad(loss, mine)
    theirs = _leaves(sp, flat)
    want_loss = R.loss({p: t for (p, *_), t in zip(sp, theirs)}, tokens,
                       labels, TINY)
    want = torch.autograd.grad(want_loss, theirs)
    torch.testing.assert_close(loss, want_loss, rtol=LOSS_TOL, atol=0)
    for (path, *_), a, b in zip(sp, got, want):
        err = float(torch.linalg.vector_norm(a - b))
        assert err <= GRAD_TOL * float(torch.linalg.vector_norm(b)), path


def test_prefill_then_decode_match_the_full_forward():
    """Prefill of 40 tokens (one SSD chunk of the port's 64, three of the
    reference's 16), then 3 decode steps through the caches: each step's
    logits against the reference's full forward at that position."""
    b = _bundle()
    sp, flat = _weights(7)
    params = _nested(sp, [t.detach() for t in _leaves(sp, flat)])
    tokens, _ = _batch(7, B=2, S=43)
    want = R.logits({p: t for (p, *_), t in zip(
        sp, [flat[o:o + n].view(s) for _, s, o, n in sp])}, tokens, TINY)
    caches = b.init_caches(2, 64, 4, dtype=torch.float32, device=CPU)
    got, caches = b.prefill(params, {"tokens": tokens[:, :40]}, caches)
    torch.testing.assert_close(got, want[:, 39], rtol=1e-4, atol=1e-5)
    for t in range(40, 43):
        got, caches = b.decode(params, caches, {"token": tokens[:, t:t + 1]})
        torch.testing.assert_close(got, want[:, t], rtol=1e-4, atol=1e-5)
    assert caches.attn.length.tolist() == [[43, 43]]


def test_serving_replicas_decode_each_slot_as_its_own_run():
    b = _bundle()
    sp, flat = _weights(3)
    params = _nested(sp, [t.detach() for t in _leaves(sp, flat)])
    tokens, _ = _batch(3, B=2, S=9)
    caches = [b.init_caches(2, 16, 2, dtype=torch.float32, device=CPU)]
    b.prefill_replicas([params], tokens[:, :8], caches)
    got = b.decode_replicas([params], caches, tokens[:, 8:9])
    one = b.init_caches(1, 16, 2, dtype=torch.float32, device=CPU)
    b.prefill(params, {"tokens": tokens[1:, :8]}, one)
    alone, _ = b.decode(params, one, {"token": tokens[1:, 8:9]})
    assert got.shape == (1, 2, TINY["vocab_size"])
    assert torch.equal(got[0, 1], alone[0])
    view = b.reset_cache_rows(caches[0], slice(0, 1))
    assert not view.mamba.ssm.any() and caches[0].mamba.ssm[:, 1].any()


def test_the_carried_state_moves_the_loss(monkeypatch):
    """With every chunk's entering state zeroed (12 chunks of 16), the
    reference's loss moves by over ten times :data:`LOSS_TOL`, and each
    Mamba2 leaf's gradient by over ten times :data:`GRAD_TOL` (``A_log``'s
    by most of its norm), at the benchmark's init laws: the SSD's
    recurrence across chunks counts."""
    sp, flat = _weights(0)
    tokens, labels = _batch(0, S=192)

    def run():
        leaves = _leaves(sp, flat)
        loss = R.loss({p: t for (p, *_), t in zip(sp, leaves)}, tokens,
                      labels, TINY)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    full, g_full = run()
    orig = R.ssd
    monkeypatch.setattr(R, "ssd", lambda *a, **k: orig(*a, carry=False, **k))
    cut, g_cut = run()
    assert abs(full - cut) / full >= 10 * LOSS_TOL, (full, cut)
    moved = {path: float(torch.linalg.vector_norm(a - b)
                         / torch.linalg.vector_norm(b))
             for (path, *_), a, b in zip(sp, g_cut, g_full)
             if path.startswith("mamba/")}
    assert min(moved.values()) >= 10 * GRAD_TOL, moved
    assert moved["mamba/A_log"] >= 0.5, moved


def _recurrence(u, la, Bm, Cm):
    B, S, H, P = u.shape
    h = torch.zeros(B, H, P, Bm.shape[-1], dtype=u.dtype)
    ys = []
    for t in range(S):
        h = torch.exp(la[:, t])[:, :, None, None] * h \
            + u[:, t, :, :, None] * Bm[:, t, None, None, :]
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("S,chunk", [(1, 4), (15, 4), (16, 16), (41, 8)])
def test_reference_ssd_equals_the_recurrence(S, chunk):
    g = torch.Generator().manual_seed(S)
    B, H, P, N = 2, 3, 4, 5
    u = torch.randn(B, S, H, P, generator=g, dtype=torch.float64)
    la = -torch.rand(B, S, H, generator=g, dtype=torch.float64)
    Bm, Cm = (torch.randn(B, S, N, generator=g, dtype=torch.float64)
              for _ in range(2))
    torch.testing.assert_close(R.ssd(u, la, Bm, Cm, chunk),
                               _recurrence(u, la, Bm, Cm))


def _qkv(seed, B=2, S=33, H=4, kvH=2, hd=64, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g).to(dtype)
    k = torch.randn(B, S, kvH, hd, generator=g).to(dtype)
    v = torch.randn(B, S, kvH, hd, generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_default_scale_is_the_explicit_one_bit_for_bit(dtype):
    """``scale`` left out is ``1/sqrt(hd)``, bit for bit, in the forward,
    the backward and the layers' plain blocked path and decode."""
    q, k, v = _qkv(1, dtype=dtype)
    s = 1.0 / math.sqrt(q.shape[-1])
    o, lse = flash.flash_attention(q, k, v, window=9)
    o2, lse2 = flash.flash_attention(q, k, v, window=9, scale=s)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)
                     ).to(dtype)
    for a, b in zip(flash.flash_attention_bwd(q, k, v, o, lse, do, window=9),
                    flash.flash_attention_bwd(q, k, v, o, lse, do, window=9,
                                              scale=s)):
        assert torch.equal(a, b)
    kw = dict(q_block=16, kv_block=8)
    assert torch.equal(L.blocked_attention(q, k, v, **kw),
                       L.blocked_attention(q, k, v, scale=s, **kw))
    cache = L.KVCache.create(2, 2, 48, 64, 4, dtype)
    L.cache_prefill(cache, k, v)
    assert torch.equal(L.flash_decode(q[:, -1:], cache),
                       L.flash_decode(q[:, -1:], cache, scale=s))


def test_flash_scale_agrees_with_the_plain_attention():
    """A non-default scale (Granite's 1/hd) through the wrappers' forward and
    backward, the blocked path and decode, against ``attention_ref`` at the
    same scale, and against it at the default scale on q rescaled."""
    q, k, v = _qkv(3)
    s = 1.0 / 64
    want = attention_ref(q, k, v, scale=s)
    torch.testing.assert_close(attention_ref(q * (s * 8.0), k, v), want)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = flash.FlashAttention.apply(*leaves, True, 0, s)
    torch.testing.assert_close(got, want)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(4))
    for a, b in zip(torch.autograd.grad(got, leaves, do),
                    torch.autograd.grad(attention_ref(*ref_leaves, scale=s),
                                        ref_leaves, do)):
        torch.testing.assert_close(a, b)
    torch.testing.assert_close(
        L.blocked_attention(q, k, v, q_block=16, kv_block=8, scale=s), want)
    cache = L.KVCache.create(2, 2, 48, 64, 4, torch.float32)
    L.cache_prefill(cache, k, v)
    torch.testing.assert_close(L.flash_decode(q[:, -1:], cache, scale=s),
                               want[:, -1:])


def test_registry_and_launchers_take_the_port_only_id():
    """The id builds through ``get_bundle`` at the published depth and at
    10 layers (the benchmark's P), is refused a 'model' axis, and trains
    and serves through the launchers; ``ARCH_IDS`` stays the JAX
    package's."""
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert ARCH not in registry.ARCH_IDS and ARCH in registry.ALL_IDS
    cfg = registry.get_config(ARCH)
    assert cfg.family == "granite_hybrid" and cfg.n_layers == 40
    assert [i for i, t in enumerate(cfg.layer_types)
            if t == "attention"] == [5, 15, 25, 35]
    b = registry.get_bundle(ARCH, depth=10)
    assert [k for k, _ in GH.slots(b.cfg)].count("attention") == 1
    from repro_torch.core.simulator import FlatTree
    assert FlatTree.from_params(b.meta_params()).size == 951_991_232
    assert FlatTree.from_params(b.meta_params()).size == sum(
        n for *_, n in refp.spans({**TINY, **_published(10)}))
    with pytest.raises(NotImplementedError, match="no tensor-parallel"):
        registry.check_model_axis(cfg, 2)
    from repro_torch.launch import serve, train
    run = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "2", "--groups", "2", "--seq", "16",
                      "--batch-per-group", "1", "--log-every", "1"])
    assert [t for t, _ in run.losses] == [0, 1]
    assert all(math.isfinite(x) for _, x in run.losses)
    ids = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prefill", "16", "--decode", "4"])
    assert tuple(ids.shape) == (2, 5)


def test_train_step_freezes_the_heap_for_the_step_alone(monkeypatch):
    """The launcher's train step freezes the objects alive at its start out
    of the collector's passes (each Mamba2 mixer sees them frozen) and
    gives them back at its end; where objects were frozen before it, the
    step leaves the freeze as it found it. The collector stays on."""
    from repro_torch.launch import train
    run = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "1", "--groups", "2", "--seq", "16",
                      "--batch-per-group", "1"])
    seen, mixer = [], M.mamba_mixer

    def spy(*args, **kw):
        seen.append((gc.isenabled(), gc.get_freeze_count()))
        return mixer(*args, **kw)

    monkeypatch.setattr(M, "mamba_mixer", spy)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, 512, (2, 1, 16), generator=gen)
             for k in ("tokens", "labels")}
    gc.unfreeze()
    state = run.step(run.state, batch)
    assert gc.get_freeze_count() == 0
    assert seen and all(on and n > 0 for on, n in seen)
    gc.freeze()
    try:
        frozen = gc.get_freeze_count()
        run.step(state, batch)
        assert gc.get_freeze_count() == frozen
    finally:
        gc.unfreeze()


def _published(depth):
    """The published widths of granite-4.0-h-micro at ``depth`` layers, as
    a configuration file's keys."""
    return {"hidden_size": 2048, "shared_intermediate_size": 8192,
            "intermediate_size": 8192, "num_attention_heads": 32,
            "num_key_value_heads": 8, "num_hidden_layers": depth,
            "vocab_size": 100352, "mamba_n_heads": 64, "mamba_d_head": 64,
            "mamba_d_state": 128, "mamba_expand": 2,
            "layer_types": list(registry.get_config(ARCH).layer_types)}


def test_reference_equals_the_published_model():
    """The reference against transformers' ``GraniteMoeHybridForCausalLM``
    on the same weights (float32, eager attention): an independent check
    of the published equations. The conv's taps are reversed and the
    matrices transposed into the published layouts."""
    tf = pytest.importorskip("transformers")
    c = {**TINY, "mamba_chunk_size": 16}
    hf_cfg = tf.GraniteMoeHybridConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        shared_intermediate_size=c["shared_intermediate_size"],
        num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c["num_key_value_heads"],
        rms_norm_eps=c["rms_norm_eps"], tie_word_embeddings=True,
        embedding_multiplier=c["embedding_multiplier"],
        logits_scaling=c["logits_scaling"],
        residual_multiplier=c["residual_multiplier"],
        attention_multiplier=c["attention_multiplier"],
        num_local_experts=0, num_experts_per_tok=0,
        position_embedding_type="nope", layer_types=c["layer_types"],
        mamba_n_heads=c["mamba_n_heads"], mamba_d_state=c["mamba_d_state"],
        mamba_d_head=c["mamba_d_head"], mamba_d_conv=c["mamba_d_conv"],
        mamba_expand=c["mamba_expand"],
        mamba_chunk_size=c["mamba_chunk_size"],
        attn_implementation="eager")
    model = tf.GraniteMoeHybridForCausalLM(hf_cfg).float().eval()
    sp, flat = _weights(13)
    p = {path: flat[o:o + n].view(s) for path, s, o, n in sp}
    j = {"mamba": 0, "attention": 0}
    sd = {"model.embed_tokens.weight": p["embed/table"],
          "model.norm.weight": p["ln_f/scale"]}
    for i, kind in enumerate(c["layer_types"]):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = p["ln_mix/scale"][i]
        sd[pre + "post_attention_layernorm.weight"] = p["ln_mlp/scale"][i]
        sd[pre + "shared_mlp.input_linear.weight"] = torch.cat(
            [p["mlp/w_gate"][i], p["mlp/w_up"][i]], dim=1).t()
        sd[pre + "shared_mlp.output_linear.weight"] = p["mlp/w_down"][i].t()
        n = j[kind]
        j[kind] += 1
        if kind == "mamba":
            m = pre + "mamba."
            sd[m + "in_proj.weight"] = p["mamba/in_proj"][n].t()
            sd[m + "conv1d.weight"] = p["mamba/conv_w"][n].flip(0).t()[
                :, None, :]
            sd[m + "conv1d.bias"] = p["mamba/conv_b"][n]
            sd[m + "A_log"] = p["mamba/A_log"][n]
            sd[m + "dt_bias"] = p["mamba/dt_bias"][n]
            sd[m + "D"] = p["mamba/D_skip"][n]
            sd[m + "norm.weight"] = p["mamba/gate_ln/scale"][n]
            sd[m + "out_proj.weight"] = p["mamba/out_proj"][n].t()
        else:
            a = pre + "self_attn."
            for w in ("q", "k", "v", "o"):
                sd[a + f"{w}_proj.weight"] = p[f"attn/w{w}"][n].t()
    missing, unexpected = model.load_state_dict(
        {k: v.contiguous() for k, v in sd.items()}, strict=False)
    assert missing == ["lm_head.weight"] and not unexpected    # tied
    tokens, _ = _batch(13, B=2, S=37)
    with torch.no_grad():
        want = model(tokens).logits
        got = R.logits(p, tokens, c)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
