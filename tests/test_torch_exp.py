"""The port's Experiment API against ``repro.exp``: the single-host,
netsim, serve, elastic and lm presets hash alike and lower to the same
netsim scenarios, specs round-trip, what is invalid fails at construction
as in JAX, ``run("smoke")`` trains on the CPU through the stepwise and fused
runners, the netsim runner carries the JAX package's cluster accounting and
staleness, the protocol runner trains an MLP and the reduced transformer
(the MoE and RWKV6 presets: ``test_torch_zoo.py``), and the serve presets
run and checkpoint."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.exp as jexp
import repro_torch.exp as exp

NETSIM = ("netsim/baseline_uniform", "netsim/byzantine_plus_slow",
          "netsim/crash_storm", "netsim/heavy_tail_stragglers",
          "netsim/membership_churn", "netsim/partitioned_dmc")
PORTED = tuple(sorted(
    ("alie_workers", "clean_async", "clean_sync", "elastic/netsim_churn",
     "elastic/planned_churn", "elastic/static", "lie_server",
     "lm/moe_tiny", "lm/rwkv_tiny", "lm/tfm_tiny", "quickstart",
     "reversed_server", "serve/ckpt_lie_server", "serve/ckpt_smoke",
     "smoke", "sync_filters") + NETSIM))


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
    (dict(runner="netsim"), ValueError, "needs a netsim scenario"),
    (dict(runner="protocol"), ValueError, "n_workers == n_servers"),
    (dict(runner="elastic"), ValueError, "n_workers == n_servers"),
    (dict(runner="elastic", delivery="trace", scenario="crash_storm"),
     ValueError, 'needs delivery="uniform"'),
    (dict(delivery="trace"), ValueError, "needs a netsim scenario"),
    (dict(membership_plan={"events": []}), ValueError,
     'runner="elastic" knob'),
    (dict(agg_backend="pallas"), ValueError, "no backend option"),
    (dict(sort_network=False), ValueError, "one sort"),
    (dict(model="tfm_tiny"), ValueError, 'runner="protocol" only'),
    (dict(scenario="nope"), ValueError, "unknown netsim scenario"),
    (dict(n_workers=6), ValueError, "3f_w"),
    (dict(gar="bulyan"), ValueError, "pytree"),
])
def test_not_ported_and_invalid_fail_at_construction(kw, err, match):
    with pytest.raises(err, match=match):
        exp.Experiment(**kw)


@pytest.mark.parametrize("kw", [
    dict(runner="elastic"), dict(membership_plan={"events": []}),
    dict(runner="stepwise", ckpt_every=5),
    dict(runner="fused", ckpt_dir="/nowhere"),
    dict(runner="elastic", n_workers=5, f_workers=1, ckpt_dir="/nowhere"),
    dict(runner="elastic", n_workers=5, f_workers=1, optimizer="adamw")])
def test_elastic_and_checkpoint_fields_validate_as_in_jax(kw):
    """The elastic runner, membership plans and the checkpoint fields are
    taken or refused at construction exactly as JAX takes or refuses them
    (same exception type; same spec hash where taken)."""
    try:
        ref = jexp.Experiment(**kw)
    except ValueError as err:
        with pytest.raises(type(err)):
            exp.Experiment(**kw)
        return
    mine = exp.Experiment(**kw)
    assert mine.to_dict() == ref.to_dict()
    assert mine.spec_hash == ref.spec_hash


@pytest.mark.parametrize("name,kw", [
    ("smoke", dict(runner="protocol")),
    ("lm/tfm_tiny", dict(steps=4, metrics_every=2, eval_n=8))])
def test_protocol_runner_trains_on_the_cpu(name, kw):
    """The protocol runner on G co-located groups: the MLP smoke task is
    learned; the reduced transformer's negative eval loss is finite and
    rises over its steps."""
    res = exp.run(name, device="cpu", **kw)
    assert res.provenance["protocol_engine"] == "sharded"
    assert res.state.t == res.experiment.steps
    assert torch.isfinite(res.state.params).all()
    json.dumps(res.to_dict())
    if name == "smoke":
        assert res.final["acc"] > 0.9
    else:
        accs = [m["acc"] for m in res.logs] + [res.final["acc"]]
        assert np.all(np.isfinite(accs)) and accs[-1] > accs[0]


@pytest.mark.parametrize("name", ["serve/ckpt_smoke",
                                  "serve/ckpt_lie_server"])
def test_serve_presets_run_and_checkpoint(name, tmp_path):
    """The serve presets train through the protocol runner on the CPU and
    leave their replica-stacked checkpoints every 5 steps, which the port's
    pool restores (the lie server's replica is outvoted by the
    consolidated read)."""
    from repro_torch.serve import ReplicaPool, checkpoint_groups
    d = str(tmp_path / "ck")
    res = exp.run(name, ckpt_dir=d, device="cpu")
    assert res.state.t == 10 and res.final["acc"] > 0.5
    assert checkpoint_groups(d) == (10, 5)
    assert checkpoint_groups(d, step=5) == (5, 5)
    pool = ReplicaPool.from_checkpoint(d, res.experiment.build_problem()[0],
                                       f=1, device="cpu")
    flat = res.state.tree.flatten(pool.params, lead=1)
    assert torch.equal(flat, res.state.params)
    cons = res.state.tree.flatten(pool.consolidated())
    honest = res.state.params[:4] if "lie" in name else res.state.params
    assert bool(((cons >= honest.min(0).values)
                 & (cons <= honest.max(0).values)).all())


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


# ---------------------------------------------------------------------------
# netsim: trace delivery through every runner but elastic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(runner="netsim", scenario="crash_storm"),
    dict(delivery="trace", scenario="crash_storm"),
    dict(runner="stepwise", delivery="trace", scenario="partitioned_dmc"),
    dict(runner="protocol", n_workers=5, f_workers=1, n_servers=5,
         delivery="trace", scenario="membership_churn")])
def test_trace_delivery_constructs_as_in_jax(kw):
    """What was refused until netsim was ported: ``runner="netsim"`` forces
    ``delivery="trace"``, and a trace delivery with a scenario constructs
    for the stepwise, fused and protocol runners, hashing as in JAX."""
    mine, ref = exp.Experiment(**kw), jexp.Experiment(**kw)
    assert mine.delivery == ref.delivery == "trace"
    assert mine.to_dict() == ref.to_dict()
    assert mine.spec_hash == ref.spec_hash


@pytest.mark.parametrize("name", NETSIM)
def test_netsim_preset_lowers_to_the_jax_scenario(name):
    """``to_scenario`` of each netsim preset (and with a payload override)
    is the JAX package's ``Scenario``, field for field."""
    for kw in ({}, dict(model_d=1_093_642, steps=150)):
        mine, ref = exp.get(name, **kw), jexp.get(name, **kw)
        assert mine.runner == "netsim" and mine.delivery == "trace"
        assert (dataclasses.asdict(mine.to_scenario())
                == dataclasses.asdict(ref.to_scenario()))
    with pytest.raises(ValueError, match="names no netsim scenario"):
        exp.get("quickstart").to_scenario()


def test_netsim_runner_matches_jax_accounting(tmp_path):
    """``run("smoke", runner="netsim", steps=6)`` on the CPU: the netsim
    dict and the logged staleness equal JAX's; the result round-trips
    through ``write_result``."""
    res = exp.run("smoke", runner="netsim", steps=6, device="cpu")
    ref = jexp.run("smoke", runner="netsim", steps=6)
    assert res.netsim == ref.netsim
    assert res.netsim["scenario"] == "baseline_uniform"
    assert res.state.t == 6
    keys = ("step", "staleness_pull_ms", "staleness_push_ms",
            "staleness_gather_ms")
    assert ([{k: m[k] for k in keys if k in m} for m in res.logs]
            == [{k: m[k] for k in keys if k in m} for m in ref.logs])
    assert "staleness_pull_ms" in res.logs[0]
    assert "virtual" in res.summary()
    path = exp.write_result(res, str(tmp_path))
    assert path.endswith("exp_smoke_netsim.json")
    with open(path) as fh:
        back = json.load(fh)
    assert back["netsim"] == json.loads(json.dumps(res.netsim))
    assert exp.Experiment.from_dict(back["experiment"]) == res.experiment
    assert back["logs"] == json.loads(json.dumps(res.logs))


@pytest.mark.parametrize("runner", ["stepwise", "protocol"])
def test_trace_delivery_trains_on_the_cpu(runner):
    """``netsim/crash_storm``'s trace (repeated senders in its starved
    quorums) through the stepwise runner and, on a G = 5 cluster, the
    protocol runner: finite params, staleness in the logs, the smoke task
    learned."""
    kw = dict(runner=runner, steps=12, metrics_every=4, eval_n=256)
    if runner == "protocol":
        kw.update(n_workers=5, f_workers=1)
    res = exp.run("netsim/crash_storm", device="cpu", **kw)
    assert res.netsim["shortfalls"] > 0 and res.netsim["steps"] == 12
    assert res.state.t == 12
    assert torch.isfinite(res.state.params).all()
    assert all("staleness_push_ms" in m for m in res.logs)
    assert res.final["acc"] > 0.5
