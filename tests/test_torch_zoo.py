"""The port's model zoo against the JAX package's: every config equals
the reference's field for field, ``get_bundle`` builds every arch,
``params_from_jax`` checks each family's tree, and the three dense configs
and dbrx (reduced; h2o-danube-3-4b at window 64 over 128 tokens, so the
window bites) match JAX's loss and gradients on shared numpy params; the
MoE and RWKV6 presets (``lm/moe_tiny``, ``lm/rwkv_tiny``) run to the end
on the CPU. (The launchers' runs of the vlm, hybrid and audio families
sit in those families' test files.)"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, jax_tree, numpy_params
import repro_torch.exp as exp
from repro.models import registry as jregistry
from repro_torch.models import registry
from repro_torch.models.convert import params_from_jax


@pytest.mark.parametrize("arch", registry.PORTED_IDS)
def test_ported_config_equals_jax(arch):
    mine = dataclasses.asdict(registry.get_config(arch))
    assert mine == dataclasses.asdict(jregistry.get_config(arch))
    assert (dataclasses.asdict(registry.get_bundle(arch, reduced=True).cfg)
            == dataclasses.asdict(jregistry.get_bundle(arch,
                                                       reduced=True).cfg))


def test_registry_builds_every_ported_arch_and_refuses_the_rest():
    """Every arch of the reference is ported (no "rest" is left): each id
    of ``ARCH_IDS`` builds its family's bundle, and an unknown arch
    raises."""
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert registry.PORTED_IDS == registry.ARCH_IDS
    for arch in registry.ARCH_IDS:
        b = registry.get_bundle(arch)
        assert b.cfg.name == arch and b.mod is not None
        assert b.cfg.family == jregistry.get_config(arch).family
    with pytest.raises(ValueError, match="unknown arch"):
        registry.get_bundle("gpt-2")


def test_params_from_jax_checks_the_tree_per_family():
    """Each family's tree converts (every leaf keeps its dtype); a tree of
    another family or width is refused with the leaf named (a MoE or RWKV
    tree has no ``blocks/mlp``, a dense one no ``mamba`` or
    ``enc_blocks``)."""
    moe = registry.get_bundle("qwen3-moe-235b-a22b", reduced=True).cfg
    ssm = registry.get_bundle("rwkv6-3b", reduced=True).cfg
    dense = registry.get_bundle("phi4-mini-3.8b", reduced=True).cfg
    hyb = registry.get_bundle("zamba2-1.2b", reduced=True).cfg
    audio = registry.get_bundle("whisper-small", reduced=True).cfg
    for cfg in (moe, ssm, dense, hyb, audio):
        tree = numpy_params(cfg, 0)
        got = params_from_jax(tree, cfg, device=CPU)
        assert set(got) == set(tree)
    half = params_from_jax(
        {k: (v.astype(np.float16) if k == "pos_dec" else v)
         for k, v in numpy_params(audio, 0).items()}, audio, device=CPU)
    assert half["pos_dec"].dtype == torch.float16
    assert half["embed"]["table"].dtype == torch.float32
    with pytest.raises(ValueError, match="blocks/mlp/w_down is missing"):
        params_from_jax(numpy_params(moe, 0), dense, device=CPU)
    with pytest.raises(ValueError, match="blocks/moe/router"):
        params_from_jax(numpy_params(dense, 0), moe, device=CPU)
    with pytest.raises(ValueError, match="blocks/Wr"):
        params_from_jax(numpy_params(
            dataclasses.replace(ssm, d_model=64), 0), ssm, device=CPU)
    with pytest.raises(ValueError, match="mamba/in_proj is missing"):
        params_from_jax(numpy_params(dense, 0), hyb, device=CPU)
    with pytest.raises(ValueError, match="shared/mlp/w_down is"):
        params_from_jax(numpy_params(
            dataclasses.replace(hyb, shared_attn_d_ff=128), 0), hyb,
            device=CPU)
    with pytest.raises(ValueError, match="enc_blocks/attn/wq is missing"):
        params_from_jax(numpy_params(hyb, 0), audio, device=CPU)
    with pytest.raises(ValueError, match="enc_blocks/attn/wq is"):
        params_from_jax(numpy_params(
            dataclasses.replace(audio, encoder_layers=3), 0), audio,
            device=CPU)


@pytest.mark.parametrize("arch,over,S", [
    ("h2o-danube-3-4b", dict(sliding_window=64), 128),
    ("phi3-medium-14b", {}, 24),
    ("internlm2-20b", {}, 24),
    ("dbrx-132b", {}, 24)])
def test_loss_and_grads_match_jax(arch, over, S):
    """f32 activations: the loss and every leaf's gradient against
    ``jax.grad`` (rtol 1e-4: the same arithmetic in other orders)."""
    over = dict(over, act_dtype="float32")
    jb = jregistry.get_bundle(arch, reduced=True, **over)
    tb = registry.get_bundle(arch, reduced=True, **over)
    if arch.startswith("h2o"):
        assert tb.cfg.sliding_window == 64 < S
    p_np = numpy_params(jb.cfg, seed=3)
    toks = np.random.default_rng(4).integers(
        0, jb.cfg.vocab, (2, S + 1)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    jl, jg = jax.value_and_grad(jb.loss)(jax_tree(p_np), jbatch)
    leaves = {}

    def track(t, path=""):
        if isinstance(t, dict):
            return {k: track(v, f"{path}/{k}") for k, v in t.items()}
        leaves[path] = t.requires_grad_()
        return t

    tl = tb.loss(track(params_from_jax(p_np, tb.cfg, device=CPU)),
                 {k: torch.from_numpy(np.array(v)).long()
                  for k, v in jbatch.items()})
    tl.backward()
    assert abs(float(tl) - float(jl)) < 1e-5
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        key = "".join(f"/{p.key}" for p in path)
        want = np.asarray(g)
        np.testing.assert_allclose(leaves[key].grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)


@pytest.mark.parametrize("name", ["lm/moe_tiny", "lm/rwkv_tiny"])
def test_zoo_presets_run_to_the_end_on_the_cpu(name):
    """The MoE and RWKV6 presets as registered (12 protocol steps, G = 4):
    every step taken, finite params in the family's ``param_dtype`` (bf16
    for the MoE, as qwen3-moe's), and a finite negative eval loss that
    rises over the run."""
    res = exp.run(name, device="cpu")
    assert res.state.t == res.experiment.steps == 12
    assert res.state.params.dtype == (torch.bfloat16 if "moe" in name
                                      else torch.float32)
    assert torch.isfinite(res.state.params.float()).all()
    accs = [m["acc"] for m in res.logs] + [res.final["acc"]]
    assert np.all(np.isfinite(accs)) and accs[-1] > accs[0]
    json.dumps(res.to_dict())

