"""The dry run of the port (``repro_torch.launch.dryrun``) and what it
stands on, against the reference on the CPU: the shape cells, the
registry's ``batch_specs`` and ``supports_cell``, the cell builders of
``launch/steps.py`` on the 16 x 16 production mesh (the reference's at
256 forced host devices, in ``tests/_torch_cells_runner.py``, through
``jax.eval_shape`` only), each kernel wrapper's meta route, and a reduced
scatter step counted on meta and on real CPU tensors alike."""
import json
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.models.registry import ARCH_IDS
from repro.models.registry import get_bundle as jax_bundle
from repro_torch.configs import shapes as tshapes
from repro_torch.core import protocol as tproto
from repro_torch.kernels import _build
from repro_torch.kernels.cwise_median import ops as order_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mda_diameter import ops as diam_ops
from repro_torch.kernels.pairwise_sqdist import ops as gram_ops
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import AXES, Mesh, RankView, production_view
from repro_torch.models.registry import get_bundle
from repro_torch.optim.schedules import inverse_linear

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode")
CELL_ARCHS = ["phi4-mini-3.8b", "qwen3-moe-235b-a22b", "qwen2-vl-7b",
              "rwkv6-3b", "zamba2-1.2b", "whisper-small"]


def test_shapes_equal_the_reference():
    assert tshapes.SHAPE_ORDER == jshapes.SHAPE_ORDER
    assert {k: asdict(v) for k, v in tshapes.SHAPES.items()} == \
        {k: asdict(v) for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_and_supports_cell_equal_the_reference(arch):
    tb, jb = get_bundle(arch), jax_bundle(arch)
    for kind in KINDS:
        want = jb.batch_specs(kind, 8, 64)
        got = tb.batch_specs(kind, 8, 64)
        assert sorted(got) == sorted(want), kind
        for name, spec in got.items():
            assert spec.is_meta
            assert tuple(spec.shape) == tuple(want[name].shape), (kind, name)
            assert str(spec.dtype)[6:] == jnp.dtype(want[name].dtype).name
    for shape in tshapes.SHAPE_ORDER:
        assert tb.supports_cell(shape) == jb.supports_cell(shape)


def test_make_batch_takes_the_shapes_of_batch_specs():
    for arch in ("phi4-mini-3.8b", "qwen2-vl-7b", "whisper-small"):
        b = get_bundle(arch, reduced=True)
        for kind in KINDS:
            got = b.make_batch(kind, 2, 16, torch.Generator().manual_seed(0))
            specs = b.batch_specs(kind, 2, 16)
            assert {k: v.shape for k, v in got.items()} == \
                {k: v.shape for k, v in specs.items()}


# ---------------------------------------------------------------------------
# the cell builders against the reference's on the production mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("cells") / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_cells_runner.py"),
         str(out), ",".join(CELL_ARCHS), ",".join(tshapes.SHAPE_ORDER)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_cell_builders_match_the_reference(ref_cells, arch):
    """G, the micro-batches, each batch input's block, each attention
    cache's k/v block and the train state's bytes a rank (before the
    'fsdp' split; after it where the reference splits every leaf) equal
    the reference's shards at 256 devices; the skips are the reference's.
    The serving params follow the port's documented rule (the training
    table's 'model' dims, ZeRO over 'data' past 4 GB a rank), the
    recurrent states stay whole on every 'model' rank."""
    view = production_view()
    for shape in tshapes.SHAPE_ORDER:
        want = ref_cells[f"{arch}|{shape}"]
        ok, why = get_bundle(arch).supports_cell(shape)
        if "skipped" in want:
            assert not ok and why == want["skipped"]
            continue
        cell = steps.build_cell(arch, tshapes.SHAPES[shape], view)
        kind = cell.meta["kind"]
        assert kind == want["kind"]
        if kind == "train":
            state, batch = cell.in_specs
            assert cell.meta["G"] == want["G"]
            assert cell.meta["pcfg"].grad_microbatches == \
                want["grad_microbatches"]
            nm = want["grad_microbatches"]
            for name, shard in want["batch"].items():
                got = list(batch[name].shape)
                if name == "positions":   # [(nm,) 3, G/rep, b/K, S]
                    assert got == shard, name
                else:
                    assert got == shard, (name, got, shard, nm)
            nbytes = sum(t.numel() * t.element_size()
                         for t in dryrun.tensors((state.params, state.opt)))
            # the port cuts the rank's flat row into K near-equal column
            # ranges, where the reference keeps a leaf that K does not
            # divide whole on every 'fsdp' rank: equal before the 'fsdp'
            # split, and equal after it where every leaf divides
            K, item = want["fsdp"], state.params.element_size()
            assert cell.mesh.size("fsdp") == K
            assert abs(nbytes * K - want["state_bytes_before_fsdp"]) \
                < K * item, (shape, nbytes)
            assert nbytes <= want["state_bytes"]
            if want["state_bytes"] * K == want["state_bytes_before_fsdp"]:
                assert nbytes == want["state_bytes"]
            continue
        params, a, b = cell.in_specs
        batch, caches = (a, b) if kind == "prefill" else (b, a)
        assert {k: list(v.shape) for k, v in batch.items()} == \
            want["batch"]
        # leaf by leaf, in the reference's order: an attention cache's k/v
        # ([L, B, kvH, nc, ck, hd]) is the reference's shard; the port
        # keeps a length per row ([L, B] for the reference's [L]) and a
        # recurrent or cross-attention state whole on every 'model' rank,
        # its batch cut as the reference's
        got = [list(t.shape) for t in dryrun.tensors(caches)]
        assert len(got) == len(want["caches"]), (shape, got)
        for g, shard, whole in zip(got, want["caches"], want["cache_shapes"]):
            if len(whole) == 6:
                assert g == shard, (shape, g, shard)
            elif len(whole) == 1:
                assert g == [whole[0], got[0][1]], (shape, g)
            else:
                assert g == whole[:1] + shard[1:2] + whole[2:], (shape, g)
        # the serving params: the port's rule
        smesh = cell.mesh
        tree = tproto.FlatTree.from_params(get_bundle(arch).meta_params(
            torch.bfloat16))
        specs = steps.serve_param_sharding(tree, smesh, get_bundle(arch).cfg)
        want_bytes = 0
        for shape_, spec in zip(tree.shapes, specs):
            n = int(np.prod(shape_))
            for axis in spec:
                n //= smesh.size(axis)
            want_bytes += 2 * n
        got_bytes = sum(t.numel() * t.element_size()
                        for t in dryrun.tensors(params))
        assert got_bytes == want_bytes


# ---------------------------------------------------------------------------
# the kernels' meta routes
# ---------------------------------------------------------------------------

def _meta(*ts):
    return [t.to("meta") for t in ts]


def _same(a, b):
    assert tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype
    assert a.is_meta


def _cases():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 64, 4, 32), generator=g).bfloat16()
    k = torch.randn((2, 64, 2, 32), generator=g).bfloat16()
    v = torch.randn((2, 64, 2, 32), generator=g).bfloat16()
    x = torch.randn((3, 5, 100), generator=g)
    d2 = ((x[:, :4, None] - x[:, None, :4]) ** 2).sum(-1)
    return q, k, v, x, d2


@pytest.fixture
def plain_refused(monkeypatch):
    """Every plain version and the library loader raise: a meta tensor
    must reach neither."""
    def boom(*a, **kw):
        raise AssertionError("a meta tensor reached a plain version")

    for mod, names in (
            (flash_ops, ("attention_ref", "flash_bwd_from_delta")),
            (order_ops, ("cwise_median_plain", "cwise_trimmed_mean_plain",
                         "cwise_meamed_plain")),
            (gram_ops, ("gram_plain",)),
            (diam_ops, ("mda_select_plain", "subset_diameters_plain"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)
    monkeypatch.setattr(_build, "load", boom)


def test_kernel_meta_routes_match_the_plain_shapes(plain_refused):
    q, k, v, x, d2 = _cases()
    qm, km, vm, xm, d2m = _meta(q, k, v, x, d2)
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref, flash_bwd_from_delta, flash_delta)
    o, lse = attention_ref(q, k, v, return_lse=True)
    mo, mlse = flash_ops.flash_attention(qm, km, vm)
    _same(mo, o)
    _same(mlse, lse)
    do = torch.randn(q.shape).bfloat16()
    delta = flash_delta(o, do).contiguous()
    want = flash_bwd_from_delta(q, k, v, do, lse, delta)
    got = flash_ops.flash_attention_bwd(qm, km, vm, *_meta(o, lse, do))
    for a, b in zip(got, want):
        _same(a, b)
    # the kernels' own operands: hd 128, contiguous
    pad = [torch.nn.functional.pad(t, (0, 96)).contiguous()
           for t in (q, k, v, do)]
    pm = _meta(*pad)
    lm, dm = _meta(lse, delta)
    _same(flash_ops.flash_bwd_dq(*pm, lm, dm, scale=0.1), pad[0])
    dk, dv = flash_ops.flash_bwd_dkv(*pm, lm, dm, scale=0.1)
    _same(dk, pad[1])
    _same(dv, pad[2])
    # the autograd function, forward and backward
    qg = qm.clone().requires_grad_()
    out = flash_ops.FlashAttention.apply(qg, km, vm, True, 0)
    _same(out, o)
    (gq,) = torch.autograd.grad(out, qg, torch.empty_like(out))
    _same(gq, q)
    # the order statistics, the Gram, the selection
    f32 = torch.float32
    for fn, args in ((order_ops.cwise_median, ()),
                     (order_ops.cwise_trimmed_mean, (1,)),
                     (order_ops.cwise_meamed, (1,))):
        got = fn(xm, *args)
        assert tuple(got.shape) == (3, 100) and got.dtype == f32
    g = gram_ops.gram(xm)
    assert tuple(g.shape) == (3, 5, 5) and g.dtype == f32 and g.is_meta
    diam, w = diam_ops.mda_select(d2m, 1)
    assert tuple(diam.shape) == (3, 4) and tuple(w.shape) == (3, 4)
    sub = diam_ops.subset_diameters(d2m, diam_ops.subset_masks(4, 1))
    assert tuple(sub.shape) == (3, 4) and sub.is_meta


def test_kernel_meta_routes_report_the_cuda_work():
    """Each wrapper reports its kernel's count on meta, and the same count
    for its plain version on a CPU tensor while counting; nothing when no
    counter is active."""
    q, k, v, x, d2 = _cases()
    calls = [(flash_ops.flash_attention, (q, k, v), {}),
             (order_ops.cwise_median, (x,), {}),
             (order_ops.cwise_meamed, (x, 1), {}),
             (gram_ops.gram, (x,), {}),
             (diam_ops.mda_select, (d2, 1), {})]
    for fn, args, kw in calls:
        seen = []
        for dev in ("cpu", "meta"):
            a = [t.to(dev) if isinstance(t, torch.Tensor) else t
                 for t in args]
            counter = dryrun.StepCounter()
            with dryrun.work.active(counter):
                fn(*a, **kw)
            seen.append(counter.kernels)
            assert counter.n_ops == 0     # not in dispatch mode here
        assert seen[0] == seen[1] and len(seen[0]) == 1, (fn, seen)


def test_visible_pairs_closed_form():
    for Sq, Skv in ((1, 1), (5, 5), (3, 9), (64, 64), (17, 100)):
        for window in (0, 1, 2, 7, 64, 200):
            i = np.arange(Sq) + (Skv - Sq)
            lo = np.maximum(0, i - window + 1) if window else 0
            want = int(np.sum(i + 1 - lo))
            assert flash_ops.visible_pairs(Sq, Skv, window, True) == want
        assert flash_ops.visible_pairs(Sq, Skv, 0, False) == Sq * Skv


# ---------------------------------------------------------------------------
# a reduced scatter step counted on meta and on real CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen3-moe-235b-a22b"])
def test_scatter_step_counts_alike_on_meta_and_cpu(arch):
    """``lm/tfm_tiny`` and ``lm/moe_tiny``'s models (the reduced phi4-mini
    and qwen3-moe), G = 4, ALIE on one worker: one scatter step under the
    counter on real CPU tensors and on meta gives the same FLOPs, the same
    kernels' counts, the same output shapes and dtypes, and the same
    arguments and outputs; meta allocates nothing."""
    from repro_torch.core.attacks import ByzantineSpec
    bundle = get_bundle(arch, reduced=True)
    pcfg = tproto.ProtocolConfig.derive(4, T=5, byz=ByzantineSpec(
        worker_attack="alie", n_byz_workers=1))
    got = {}
    for dev in ("cpu", "meta"):
        state = tproto.make_init_fn(bundle, pcfg, device=dev)(0)
        batch = {k: torch.zeros((4, 2) + tuple(v.shape[1:]), dtype=v.dtype,
                                device=dev)
                 for k, v in bundle.batch_specs("train", 2, 32).items()}
        step = tproto.make_scatter_step(bundle, pcfg,
                                        inverse_linear(0.05, 0.01),
                                        with_attack=True)
        fig, out = dryrun.measure(step, (state, batch))
        got[dev] = (fig, out.params)
    (cpu, pc), (meta, pm) = got["cpu"], got["meta"]
    assert cpu["flops"] == meta["flops"] > 0
    assert cpu["kernels"] == meta["kernels"]
    assert set(meta["kernels"]) >= {"flash_attention", "flash_bwd_dq",
                                    "flash_bwd_dkv", "gram",
                                    "subset_diameters", "cwise_median"}
    assert pc.shape == pm.shape and pc.dtype == pm.dtype and pm.is_meta
    # the plain versions hold their own temporaries on the CPU: the
    # arguments and the outputs are the same
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert cpu["memory"][key] == meta["memory"][key] > 0
    assert meta["memory"]["peak_bytes"] > meta["memory"]["argument_bytes"]


# ---------------------------------------------------------------------------
# the rank view
# ---------------------------------------------------------------------------

def test_rank_view_refuses_real_tensors_and_counts_as_mesh():
    view = RankView(AXES, (2, 1, 2), rank=3)
    x = torch.zeros(4, 6)
    for call in (lambda: view.all_gather(x, "rep", "t"),
                 lambda: view.all_to_all(x, "rep", "t"),
                 lambda: view.broadcast(x, "rep", "t")):
        with pytest.raises(ValueError, match="meta"):
            call()
    m = x.to("meta")
    assert tuple(view.all_gather(m, "rep", "g").shape) == (8, 6)
    assert tuple(view.all_to_all(m, "model", "a").shape) == (4, 6)
    view.broadcast(m, "rep", "b", src=1)      # rank 3 is rep coordinate 1
    view.broadcast(m, "rep", "c", src=0)
    assert view.sent == {"g": 4 * 6 * 4, "a": 2 * 6 * 4, "b": 4 * 6 * 4}
    assert view.calls == {"g": 1, "a": 1, "b": 1, "c": 1}
    assert view.all_gather(m, "fsdp", "x") is m     # an axis of one
    with pytest.raises(ValueError, match="ranks"):
        from repro_torch.launch.mesh import make_production_mesh
        make_production_mesh()
    p = production_view(rank=37)
    assert p.coords == (2, 5) and p.n_ranks == 256
    b = steps.meshlib.make_byz_mesh(p, 16)
    assert b.sizes == {"rep": 16, "fsdp": 1, "model": 16}
    assert b.rank == 37 and b.coords == (2, 0, 5)
    assert isinstance(steps.meshlib.make_serve_mesh(p), RankView)
    assert isinstance(Mesh(("data",), (1,)), Mesh)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_dryrun_cli_writes_an_artifact_that_roofline_reads(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "phi4-mini-3.8b", "--shape", "prefill_32k,long_500k", "--reduced",
         "--results-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "done: 1 ok, 1 skipped, 0 failed" in run.stdout
    path = tmp_path / "16x16" / "phi4-mini-3.8b__prefill_32k__naive__reduced.json"
    res = json.loads(path.read_text())
    assert res["full"]["flops"] > 0 and res["n_devices"] == 256
    assert res["full"]["kernels"]["flash_attention"]["calls"] == 2
    again = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "phi4-mini-3.8b", "--shape", "prefill_32k", "--reduced",
         "--results-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert "[cached]" in again.stdout
    table = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline",
         "--results-dir", str(tmp_path), "--tag", "__reduced"],
        env=env, capture_output=True, text=True, timeout=300)
    assert table.returncode == 0, table.stderr[-3000:]
    line = [l for l in table.stdout.splitlines()
            if l.startswith("phi4-mini-3.8b") and "prefill_32k" in l]
    assert line and "SKIP" not in line[0], table.stdout
    assert "H100 SXM published peaks" in table.stdout
