"""The port's checkpointer against ``repro.checkpoint``, on the CPU: the
format both ways (a JAX checkpoint restores into the port, bf16 leaves by
their bits, AdamW state included; a port checkpoint restores through the
JAX ``restore``, with the manifest JAX writes but for the port's ``.gen``),
the directory hygiene of ``tests/test_checkpoint.py`` (stray entries,
orphan ``.tmp`` directories, atomic saves), ``restore_consolidated``
against JAX's for odd and even replica counts with a corrupted replica,
and the resumable paths that stand on it: the streams' ``skip``, the
protocol runner chunked at checkpoint boundaries, and ``launch.train``
killed and resumed (bit-equal, no step repeated) with ``launch.serve``
serving its checkpoint."""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.exp as jexp
import repro_torch.exp as exp
from repro.checkpoint import checkpointer as jck
from repro.configs import paper_models as jmodels
from repro.core import protocol as jproto
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.core import protocol as tproto
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import protocol_state_from_jax

TEMPLATE = tproto.ByzState(params=None, t=0, gen=None)


def _np_state(jstate):
    return jax.tree.map(np.asarray, jstate)


def _manifest(d, step):
    with open(os.path.join(jck.step_dir(d, step), "manifest.json")) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# JAX checkpoint -> port
# ---------------------------------------------------------------------------


def test_jax_serve_checkpoint_restores_into_the_port(tmp_path):
    """``serve/ckpt_smoke`` trained and saved by JAX: every leaf the port
    restores equals the JAX state's, the step counter too; the names are
    the JAX checkpoint's own (``.params/w0``, ``.t``, ``.key``)."""
    d = str(tmp_path / "jax")
    res = jexp.run("serve/ckpt_smoke", ckpt_dir=d)
    assert jck.latest_step(d) == ck.latest_step(d) == 10
    names = list(_manifest(d, 10)["leaves"])
    assert ".t" in names and ".key" in names
    want = protocol_state_from_jax(_np_state(res.state), "cpu")
    state, step = ck.restore(d, 10, TEMPLATE, "cpu")
    assert step == 10 and state.t == want.t == 10
    assert torch.equal(state.params, want.params)
    assert [".params/" + "/".join(p) for p in state.tree.paths] == [
        n for n in names if n.startswith(".params/")]
    assert state.opt == () and state.gen.device.type == "cpu"
    # the port's own engine tree names the same leaves: a restore into it
    # (as a resume does) gives the same stack
    port_state = exp.run("serve/ckpt_smoke", device="cpu", steps=1,
                         ckpt_every=None).state
    again, _ = ck.restore(d, 10, port_state, "cpu")
    assert torch.equal(again.params, want.params)


def _mixed_jax_state(G=3, seed=0):
    """A hand-built JAX ByzState: bf16 params, AdamW's f32 moments and
    int32 count, a PRNG key."""
    rng = np.random.default_rng(seed)
    params = {"dense": {"w": rng.standard_normal((G, 4, 6)),
                        "b": rng.standard_normal((G, 6))},
              "head": rng.standard_normal((G, 6, 2))}
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    opt = jadamw.AdamWState(
        jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape), jnp.float32), params),
        jax.tree.map(lambda p: jnp.asarray(
            rng.random(p.shape), jnp.float32), params),
        jnp.asarray(7, jnp.int32))
    return jproto.ByzState(params=params, t=jnp.asarray(7, jnp.int32),
                           key=jax.random.PRNGKey(seed), opt=opt)


def test_jax_bf16_and_adamw_state_restores_bit_equal(tmp_path):
    """bf16 params (written as their bits, which JAX's own restore cannot
    read back), f32 moments and the int32 count: the port's ByzState holds
    them bit for bit; a nested-dict restore of the mixed leaves too."""
    jstate = _mixed_jax_state()
    d = str(tmp_path / "jax")
    jck.save(d, 7, jstate)
    info = _manifest(d, 7)["leaves"]
    assert info[".params/dense/w"]["dtype"] == "bfloat16"
    assert info[".opt/.m/dense/w"]["dtype"] == "float32"
    state, step = ck.restore(d, 7, TEMPLATE, "cpu")
    assert step == 7 and state.t == 7 and state.opt.count == 7
    assert state.params.dtype == torch.bfloat16
    np_state = _np_state(jstate)
    for prefix, flat in ((".params", state.params), (".opt/.m", state.opt.m),
                         (".opt/.v", state.opt.v)):
        tree = np_state.params if prefix == ".params" else (
            np_state.opt.m if prefix == ".opt/.m" else np_state.opt.v)
        for path, leaf in zip(state.tree.paths,
                              state.tree.leaves(state.tree.unflatten(flat))):
            want = tree
            for k in path:
                want = want[k]
            got = leaf.contiguous()
            if got.dtype == torch.bfloat16:
                got = got.view(torch.int16).numpy()
                want = np.asarray(want).view(np.int16)
            np.testing.assert_array_equal(np.asarray(got), want,
                                          err_msg=f"{prefix}/{path}")
    like = {"w": 0, "b": 0}
    mixed = {"w": np.asarray(np_state.params["dense"]["w"]),
             "b": np.asarray(np_state.opt.v["dense"]["b"])}
    jck.save(d, 8, jax.tree.map(jnp.asarray, mixed))
    back, _ = ck.restore(d, 8, like, "cpu")
    assert back["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["w"].view(torch.int16).numpy(),
                                  mixed["w"].view(np.int16))
    np.testing.assert_array_equal(back["b"].numpy(), mixed["b"])


def test_port_writes_bf16_as_jax_does(tmp_path):
    """The port's bf16 leaf file is JAX's byte for byte, and its manifest
    entry the same."""
    a = np.random.default_rng(3).standard_normal((2, 5)).astype(
        ml_dtypes.bfloat16)
    jck.save(str(tmp_path / "j"), 1, {"x": jnp.asarray(a)})
    ck.save(str(tmp_path / "t"), 1, {"x": torch.from_numpy(
        a.view(np.int16).copy()).view(torch.bfloat16)})
    files = [os.path.join(jck.step_dir(str(tmp_path / s), 1), "x.npy")
             for s in ("j", "t")]
    with open(files[0], "rb") as f0, open(files[1], "rb") as f1:
        assert f0.read() == f1.read()
    assert _manifest(str(tmp_path / "j"), 1) == _manifest(
        str(tmp_path / "t"), 1)


# ---------------------------------------------------------------------------
# port checkpoint -> JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_port_checkpoint_restores_through_jax(tmp_path, optimizer):
    """A port protocol state saved by the port: JAX's ``restore`` (into the
    JAX engine's state shape) gives equal params, ``t`` and AdamW state, and
    the manifest is the one JAX writes for that state, but for ``.gen``."""
    init, loss, _ = jmodels.make_mlp_problem(6, 8, 3)
    jp = jproto.ProtocolConfig.derive(4, T=3, optimizer=optimizer)
    jstate = jproto.make_init_fn(jproto.ProblemBundle(init, loss), jp)(
        jax.random.PRNGKey(0))
    tstate = protocol_state_from_jax(_np_state(jstate), "cpu", seed=5)
    tstate = tstate._replace(t=9)
    if optimizer == "adamw":
        m = torch.randn(tstate.params.shape, generator=torch.Generator()
                        .manual_seed(1))
        tstate = tstate._replace(opt=tstate.opt._replace(
            m=m, v=m.abs(), count=4))
    d, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    ck.save(d, 9, tstate)
    back, step = jck.restore(d, 9, jax.eval_shape(lambda: jstate))
    assert step == 9 and int(back.t) == 9
    got = protocol_state_from_jax(_np_state(back), "cpu")
    assert torch.equal(got.params, tstate.params)
    if optimizer == "adamw":
        assert torch.equal(got.opt.m, tstate.opt.m)
        assert torch.equal(got.opt.v, tstate.opt.v)
        assert got.opt.count == 4
    jck.save(dj, 9, jstate)
    mine, ref = _manifest(d, 9), _manifest(dj, 9)
    gen = mine["leaves"].pop(".gen")
    assert gen["dtype"] == "uint8" and gen["file"] == ".gen.npy"
    assert list(mine["leaves"]) == list(ref["leaves"])
    assert mine == ref


def test_port_state_round_trip_keeps_the_random_stream(tmp_path):
    """A full port restore carries the generator: the restored run draws
    what the saved one would have drawn next."""
    init, loss, _ = jmodels.make_mlp_problem(6, 8, 3)
    tstate = protocol_state_from_jax(_np_state(jproto.make_init_fn(
        jproto.ProblemBundle(init, loss), jproto.ProtocolConfig.derive(4))(
        jax.random.PRNGKey(0))), "cpu", seed=11)
    torch.rand(7, generator=tstate.gen)
    ck.save(str(tmp_path), 3, tstate)
    back, _ = ck.restore(str(tmp_path), 3, tstate, "cpu")
    assert torch.equal(torch.rand(5, generator=back.gen),
                       torch.rand(5, generator=tstate.gen))
    only, _ = ck.restore(str(tmp_path), 3, TEMPLATE, "cpu", params_only=True)
    assert torch.equal(only.params, tstate.params) and only.opt == ()


# ---------------------------------------------------------------------------
# directory hygiene (tests/test_checkpoint.py on the port)
# ---------------------------------------------------------------------------


def _state(n_rep=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((n_rep, 6, 4), generator=g),
                       "b": torch.arange(n_rep * 3,
                                         dtype=torch.float32).reshape(n_rep,
                                                                      3)},
            "step": torch.tensor(17, dtype=torch.int32)}


def test_roundtrip_and_latest(tmp_path):
    d = str(tmp_path / "ckpt")
    s = _state()
    for step in (1, 17, 3):
        ck.save(d, step, s)
    assert ck.latest_step(d) == 17
    back, step = ck.restore(d, 17, s, "cpu")
    assert step == 17
    for k in ("w", "b"):
        assert torch.equal(back["params"][k], s["params"][k])
    assert int(back["step"]) == 17
    assert not any(f.endswith(".tmp") for f in os.listdir(d))


def test_latest_step_ignores_stray_entries(tmp_path):
    """Stray files, malformed step names and ``.tmp`` leftovers neither
    break nor win the latest-step scan, as in JAX."""
    d = tmp_path / "ckpt"
    ck.save(str(d), 3, _state())
    (d / "README.txt").write_text("notes")
    (d / "step_notanumber").mkdir()
    (d / "step_00000009.tmp").mkdir()
    (d / "step_00000007").mkdir()
    assert ck.latest_step(str(d)) == jck.latest_step(str(d)) == 3
    assert ck.latest_step(str(tmp_path / "absent")) is None


def test_save_gcs_orphan_tmp_dirs(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    orphan = d / "step_00000005.tmp"
    orphan.mkdir()
    (orphan / "junk.npy").write_bytes(b"\x00")
    ck.save(str(d), 6, _state())
    assert not any(e.endswith(".tmp") for e in os.listdir(d))
    assert ck.latest_step(str(d)) == 6


def test_interrupted_save_never_shadows_the_last_good_one(tmp_path,
                                                          monkeypatch):
    """A save killed mid-write leaves its ``.tmp`` directory only: the last
    complete step stays the latest and restores whole; the next save
    clears the leftover."""
    d = str(tmp_path / "ckpt")
    good = _state(seed=1)
    ck.save(d, 4, good)
    calls = []

    class Killed(Exception):
        pass

    def dying_save(path, arr):
        calls.append(path)
        if len(calls) == 2:
            raise Killed
        with open(path, "wb") as fh:
            np.lib.format.write_array(fh, np.asarray(arr))

    monkeypatch.setattr(np, "save", dying_save)
    with pytest.raises(Killed):
        ck.save(d, 8, _state(seed=2))
    monkeypatch.undo()
    assert os.path.isdir(ck.step_dir(d, 8) + ".tmp")
    assert not os.path.exists(ck.step_dir(d, 8))
    assert ck.latest_step(d) == 4
    back, _ = ck.restore(d, 4, good, "cpu")
    assert torch.equal(back["params"]["w"], good["params"]["w"])
    ck.save(d, 5, good)
    assert not os.path.exists(ck.step_dir(d, 8) + ".tmp")


def test_save_overwrites_the_same_step(tmp_path):
    """Saving a step again replaces it (the elastic runner's boundary save
    over its chunk save)."""
    d = str(tmp_path / "ckpt")
    ck.save(d, 2, _state(seed=1), meta={"active": [0, 1, 2, 3]})
    ck.save(d, 2, _state(n_rep=3, seed=2), meta={"active": [0, 1, 2]})
    assert ck.read_manifest(d, 2)["meta"] == {"active": [0, 1, 2]}
    back, _ = ck.restore(d, 2, _state(n_rep=3), "cpu")
    assert torch.equal(back["params"]["w"], _state(n_rep=3,
                                                   seed=2)["params"]["w"])


# ---------------------------------------------------------------------------
# restore_consolidated
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R", [4, 5])
def test_restore_consolidated_matches_jax_and_outvotes(tmp_path, R):
    """A checkpoint written by JAX with the last replica corrupted to 1e9:
    the port's median-of-replicas restore equals JAX's (nested dict), the
    corruption is outvoted, and a ByzState restore collapses the same
    values into one ``[P]`` model."""
    rng = np.random.default_rng(R)
    params = {"w": rng.standard_normal((R, 6, 4)).astype(np.float32),
              "b": rng.standard_normal((R, 3)).astype(np.float32)}
    params["w"][R - 1] = 1e9
    d = str(tmp_path / "ckpt")
    tree = {"params": jax.tree.map(jnp.asarray, params),
            "step": jnp.asarray(17)}
    jck.save(d, 1, tree)
    want, _ = jck.restore_consolidated(d, 1, jax.eval_shape(lambda: tree))
    got, step = ck.restore_consolidated(d, 1, {"params": {"w": 0, "b": 0},
                                               "step": 0}, "cpu")
    assert step == 1 and int(got["step"]) == 17
    for k in ("w", "b"):
        np.testing.assert_allclose(got["params"][k].numpy(),
                                   np.asarray(want["params"][k]),
                                   rtol=1e-7, atol=0)
    assert float(got["params"]["w"].abs().max()) < 100.0
    state = jproto.ByzState(params=tree["params"], t=jnp.asarray(3),
                            key=jax.random.PRNGKey(0))
    jck.save(d, 2, state)
    cons, _ = ck.restore_consolidated(d, 2, TEMPLATE, "cpu")
    assert cons.params.shape == (cons.tree.size,) and cons.t == 3
    flat = cons.tree.unflatten(cons.params)
    for k in ("w", "b"):
        np.testing.assert_allclose(flat[k].numpy(),
                                   np.asarray(want["params"][k]),
                                   rtol=1e-7, atol=0)


# ---------------------------------------------------------------------------
# resumable paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mixture", "tokens"])
def test_skip_is_next_dropped_and_narrow_draws_stay_aligned(kind):
    """``skip(n)`` advances exactly as ``next(n)`` does; ``next(L,
    n_workers=k)`` is the first k rows of the full-width draw, and the
    stream after it is the full-width stream's."""
    def make():
        if kind == "mixture":
            return tpipe.DeviceBatchStream(0, tpipe.MixtureSpec(5, 16), 5, 3,
                                           "cpu")
        return tpipe.DeviceTokenStream(0, tpipe.TokenSpec(64, 8), 5, 3,
                                       "cpu")

    def leaves(b):
        return list(b.values()) if isinstance(b, dict) else list(b)

    a, b, c = make(), make(), make()
    a.skip(3)
    b.next(3)
    for x, y in zip(leaves(a.next(2)), leaves(b.next(2))):
        assert torch.equal(x, y)
    full = leaves(c.next(4))
    narrow_stream = make()
    narrow = leaves(narrow_stream.next(2, n_workers=4))
    rest = leaves(narrow_stream.next(2))
    for f, n, r in zip(full, narrow, rest):
        assert n.shape[1] == 4
        assert torch.equal(f[:2, :4], n) and torch.equal(f[2:], r)
    with pytest.raises(ValueError, match="draws 1..5"):
        make().next(1, n_workers=6)


def test_chunked_protocol_run_equals_unchunked(tmp_path):
    """``serve/ckpt_smoke`` saved every 5 steps equals the same run in one
    piece bit for bit (params, metric buffers, logs), and each save holds
    the state after that many steps."""
    d = str(tmp_path / "ck")
    chunked = exp.run("serve/ckpt_smoke", ckpt_dir=d, ckpt_every=3,
                      device="cpu")
    whole = exp.run("serve/ckpt_smoke", ckpt_every=None, device="cpu")
    assert torch.equal(chunked.state.params, whole.state.params)
    assert chunked.logs == whole.logs and chunked.final == whole.final
    for k in whole.buffers:
        np.testing.assert_array_equal(chunked.buffers[k], whole.buffers[k])
    assert sorted(os.listdir(d)) == [f"step_{s:08d}" for s in (3, 6, 9, 10)]
    last, _ = ck.restore(d, 10, chunked.state, "cpu")
    assert last.t == 10 and torch.equal(last.params, whole.state.params)
    mid, _ = ck.restore(d, 6, chunked.state, "cpu")
    assert mid.t == 6


def test_ckpt_every_without_ckpt_dir_raises_as_in_jax():
    with pytest.raises(ValueError) as mine:
        exp.run("serve/ckpt_smoke", device="cpu")
    with pytest.raises(ValueError) as ref:
        jexp.run("serve/ckpt_smoke")
    assert str(mine.value) == str(ref.value)


TRAIN = ["--reduced", "--device", "cpu", "--groups", "4", "--seq", "16",
         "--batch-per-group", "2", "--T", "3", "--log-every", "1"]


def test_launch_train_kill_and_resume_is_bit_equal(tmp_path):
    """``launch.train`` 12 steps in one go against 7 steps, killed, and
    resumed to 12: equal final params, ``t`` 12, the resumed run takes
    steps 7..11 only, and every save is labelled by the steps it holds."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    whole = ttrain.main(TRAIN + ["--steps", "12", "--ckpt-dir", a,
                                 "--ckpt-every", "5"])
    first = ttrain.main(TRAIN + ["--steps", "7", "--ckpt-dir", b,
                                 "--ckpt-every", "5"])
    resumed = ttrain.main(TRAIN + ["--steps", "12", "--ckpt-dir", b,
                                   "--ckpt-every", "5"])
    assert first.state.t == 7 and resumed.state.t == whole.state.t == 12
    assert torch.equal(resumed.state.params, whole.state.params)
    assert [i for i, _ in resumed.losses] == list(range(7, 12))
    assert len(resumed.step_s) == 5
    assert sorted(os.listdir(b)) == [f"step_{s:08d}" for s in (5, 7, 10, 12)]
    for s in (5, 7, 10, 12):
        state, _ = ck.restore(b, s, TEMPLATE, "cpu", params_only=True)
        assert state.t == s


def test_launch_serve_from_a_checkpoint(tmp_path):
    """``launch.serve --ckpt-dir`` (median-consolidated, bf16) and
    ``--ckpt-dir --quorum`` (every replica behind quorum reads) on a
    ``launch.train`` checkpoint, on the CPU."""
    d = str(tmp_path / "ck")
    ttrain.main(TRAIN + ["--steps", "2", "--ckpt-dir", d])
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--prefill",
            "8", "--decode", "3", "--ckpt-dir", d]
    toks = tserve.main(argv)
    assert toks.shape == (2, 4)
    rep = tserve.main(argv + ["--quorum"])
    assert rep["n_replicas"] == 4 and rep["f"] == 1
    assert rep["committed_tokens"] == 6 and rep["requests"]["done"] == 2
    with pytest.raises(SystemExit, match="pass --ckpt-dir"):
        tserve.main(["--reduced", "--device", "cpu", "--quorum"])
