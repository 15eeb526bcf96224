"""The port's Experiment API against ``repro.exp``: the eight single-host
presets hash alike, specs round-trip, what is not ported fails at
construction, and ``run("smoke")`` trains on the CPU through both
runners."""
import json

import numpy as np
import pytest
import torch

import repro.exp as jexp
import repro_torch.exp as exp

PORTED = ("alie_workers", "clean_async", "clean_sync", "lie_server",
          "quickstart", "reversed_server", "smoke", "sync_filters")


@pytest.mark.parametrize("name", PORTED)
def test_preset_spec_hash_matches_jax(name):
    mine, ref = exp.get(name), jexp.get(name)
    assert mine.to_dict() == ref.to_dict()
    assert mine.spec_hash == ref.spec_hash
    assert exp.Experiment.from_dict(json.loads(json.dumps(
        mine.to_dict()))) == mine


def test_overrides_hash_alike_and_presets_listed():
    assert exp.names() == PORTED
    kw = dict(model="mlp_h1024", steps=150, gar="trimmed_mean")
    assert (exp.get("quickstart", **kw).spec_hash
            == jexp.get("quickstart", **kw).spec_hash)
    assert set(exp.MODELS) == set(jexp.MODELS)
    assert set(exp.DATA) == set(jexp.DATA)


@pytest.mark.parametrize("kw,err,match", [
    (dict(runner="netsim"), NotImplementedError, "Queue 1 item 6"),
    (dict(runner="protocol"), NotImplementedError, "item 9"),
    (dict(runner="elastic"), NotImplementedError, "item 10"),
    (dict(delivery="trace", scenario="crash_storm"), NotImplementedError,
     "item 6"),
    (dict(membership_plan={"events": []}), NotImplementedError, "item 10"),
    (dict(agg_backend="pallas"), ValueError, "no backend option"),
    (dict(sort_network=False), ValueError, "one sort"),
    (dict(model="tfm_tiny"), ValueError, "item 8"),
    (dict(scenario="nope"), ValueError, "unknown netsim scenario"),
    (dict(n_workers=6), ValueError, "3f_w"),
    (dict(gar="bulyan"), ValueError, "pytree"),
])
def test_not_ported_and_invalid_fail_at_construction(kw, err, match):
    with pytest.raises(err, match=match):
        exp.Experiment(**kw)


def test_run_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default run would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp.run("smoke")


@pytest.mark.parametrize("name", ["smoke", "clean_sync"])
def test_run_on_the_cpu_fused_equals_stepwise(name):
    """The preset through both runners on the CPU: the same final params
    bit for bit, the same logged accuracy; the smoke task is learned."""
    kw = dict(steps=12, batch=8, model="mlp_h32", data="mixture5_small",
              T=5, metrics_every=5, eval_n=256) if name != "smoke" else {}
    fused = exp.run(name, device="cpu", **kw)
    step = exp.run(name, device="cpu", runner="stepwise", **kw)
    assert torch.equal(fused.state.params, step.state.params)
    assert [m["acc"] for m in fused.logs] == [m["acc"] for m in step.logs]
    assert fused.provenance["device"] == "cpu"
    assert fused.provenance["spec_hash"] == exp.get(name, **kw).spec_hash
    json.dumps(fused.to_dict())
    if name == "smoke":
        assert fused.final["acc"] > 0.9
        assert fused.buffers["acc"].shape == (12,)
        assert np.all(fused.buffers["acc"][1:5] == 0)
    else:
        assert "rejects" in fused.final
