"""repro_torch.analyze on the CPU: the rules carried over from
``repro.analyze`` give the same findings as the reference on the same
fixtures (each written under ``src/repro/`` and ``src/repro_torch/`` of one
tree, the package prefix mapped); trip and clean fixtures for the rules
that are new or re-aimed (the CUDA-source audit, the build key, the
generator rule, the strict environment rule, the step-rooted host-sync
rule, the in-place run); the live tree clean modulo the committed
baseline, with every rule run; and the fixed order of
``models/layers.whole_leaves``' gathers."""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch's threads per xdist worker)
import repro.analyze as ref_analyze
import repro_torch.analyze as port_analyze
from repro.analyze import findings as ref_findings
from repro_torch.analyze import findings as port_findings
from repro_torch.analyze import run as port_run
from repro_torch.analyze.registry import rules as port_rules
from repro_torch.analyze.rules import (build_key, cuda_audit, determinism,
                                       env_hygiene, host_sync)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKGS = {"ref": "repro", "port": "repro_torch"}


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

MINI_REGISTRY = """
register(Aggregator(name="mda", requires=(2, 1), selection_based=True,
                    weights_from_d2=rules.mda_weights_from_d2))
register(Aggregator(name="median", requires=(2, 1),
                    masked_fn=rules.masked_coordinate_median))
register(Aggregator(name="bulyan", requires=(4, 3)))
register(Aggregator(name="mean", requires=(0, 1),
                    masked_fn=rules.masked_mean))
"""

MEAN_BYPASS = """\
def train(state, grads, byz, key):
    grads = inject_gradients(grads, byz, key)
    g_hat = mean(grads)
    new_params = state.params - 0.01 * g_hat
    return SimState(params=new_params)
"""

BAD_PRESET = (
    "register(Experiment(name='bad', n_workers=2, f_workers=0,\n"
    "    n_servers=2, f_servers=0,\n"
    "    membership_plan=MembershipPlan(events=(\n"
    "        MembershipEvent(step=4, kind='leave', group=1),))))\n")


def _spec_src(pkg: str) -> str:
    with open(os.path.join(ROOT, "src", pkg, "exp", "spec.py")) as f:
        return f.read()


def _taint(flow: str) -> dict:
    return {"agg/registry.py": MINI_REGISTRY, "core/flow.py": flow}


PARITY = {
    # REPRO-BYZ-BOUNDS on the package's own Experiment defaults
    "bounds-bad-cluster": (["REPRO-BYZ-BOUNDS"], {
        "exp/spec.py": "{spec}",
        "exp/presets.py":
            "register(Experiment(name='a', n_workers=3, f_workers=1,\n"
            "    n_servers=5, f_servers=1))\n"
            "register(Experiment(name='b', n_workers=9, f_workers=1,\n"
            "    n_servers=4, f_servers=1))\n"
            "register(Experiment(name='ok', n_workers=9, f_workers=1,\n"
            "    n_servers=5, f_servers=1))\n"}),
    "bounds-common-dict": (["REPRO-BYZ-BOUNDS"], {
        "exp/spec.py": "{spec}",
        "exp/presets.py":
            "_C = dict(n_workers=4, f_workers=1, n_servers=4, f_servers=1)\n"
            "register(Experiment(name='c', **_C))\n"
            "register(Experiment(name='s', variant='sync', n_workers=3,\n"
            "    f_workers=1, n_servers=5, f_servers=1))\n"}),
    "bounds-no-presets": (["REPRO-BYZ-BOUNDS"], {
        "exp/spec.py": "{spec}", "exp/presets.py": "X = 1\n"}),
    # REPRO-MEMBERSHIP-FLOOR
    "floor-unguarded-shrink": (["REPRO-MEMBERSHIP-FLOOR"], {
        "serve/pool.py": "class Pool:\n    def eject(self, i):\n"
                         "        self.active[i] = False\n"}),
    "floor-intersection": (["REPRO-MEMBERSHIP-FLOOR"], {
        "serve/prune.py":
            "def prune(pool, mask):\n    pool.active &= mask\n"}),
    "floor-guarded": (["REPRO-MEMBERSHIP-FLOOR"], {
        "serve/pool.py":
            "class Pool:\n    def eject(self, i):\n"
            "        if self.n_active - 1 < self.quorum_floor:\n"
            "            return False\n"
            "        self.active[i] = False\n"}),
    "floor-plan-below-two": (["REPRO-MEMBERSHIP-FLOOR"], {
        "exp/plans.py": BAD_PRESET}),
    "floor-plan-byz-cap": (["REPRO-MEMBERSHIP-FLOOR"], {
        "exp/plans.py":
            "_COMMON = dict(n_workers=5, f_workers=1, n_servers=5,"
            " f_servers=1)\n"
            "register(Experiment(name='bad3',\n"
            "    byz=ByzantineSpec(worker_attack='alie', n_byz_workers=1),\n"
            "    membership_plan=MembershipPlan(events=(\n"
            "        MembershipEvent(step=4, kind='leave', group=4),\n"
            "        MembershipEvent(step=5, kind='leave', group=3),)),\n"
            "    **_COMMON))\n"}),
    "floor-plan-ok": (["REPRO-MEMBERSHIP-FLOOR"], {
        "exp/plans.py":
            "register(Experiment(name='ok', n_workers=5, f_workers=1,\n"
            "    n_servers=5, f_servers=1,\n"
            "    membership_plan=MembershipPlan(events=(\n"
            "        MembershipEvent(step=4, kind='leave', group=4),\n"
            "        MembershipEvent(step=8, kind='join', group=4)))))\n"}),
    # REPRO-DEAD-SEED
    "dead-orphan": (["REPRO-DEAD-SEED"], {
        "core/used.py": "def f():\n    return 1\n",
        "core/orphan.py": "def g():\n    return 2\n",
        "__init__.py": "from .core import used\n"}),
    "dead-dynamic-literal": (["REPRO-DEAD-SEED"], {
        "configs/arch.py": "CONFIG = 1\n",
        "loader.py":
            'MODULES = {{"arch": "{pkg}.configs.arch"}}\n'
            "def load(k):\n"
            "    return importlib.import_module(MODULES[k]).CONFIG\n"}),
    "dead-exempt": (["REPRO-DEAD-SEED"], {
        "kernels/k/ref.py": "def ref():\n    pass\n",
        "cli.py": 'def main():\n    pass\nif __name__ == "__main__":\n'
                  "    main()\n"}),
    # REPRO-TAINT-BYZ
    "taint-mean-bypass": (["REPRO-TAINT-BYZ"], _taint(MEAN_BYPASS)),
    "taint-robust": (["REPRO-TAINT-BYZ"], _taint(
        MEAN_BYPASS.replace("mean(grads)", "median(grads)"))),
    "taint-get-mean": (["REPRO-TAINT-BYZ"], _taint(
        MEAN_BYPASS.replace("mean(grads)", 'agg.get("mean")(grads)'))),
    "taint-get-median": (["REPRO-TAINT-BYZ"], _taint(
        MEAN_BYPASS.replace("mean(grads)", 'agg.get("median")(grads, 1)'))),
    "taint-masked-bulyan": (["REPRO-TAINT-BYZ"], _taint(MEAN_BYPASS.replace(
        "mean(grads)", 'agg.get("bulyan")(grads, 1, mask=m)'))),
    "taint-masked-median": (["REPRO-TAINT-BYZ"], _taint(MEAN_BYPASS.replace(
        "mean(grads)", 'agg.get("median")(grads, 1, mask=m)'))),
    "taint-selection-weights": (["REPRO-TAINT-BYZ"], _taint(
        "def train(state, grads, byz, key):\n"
        "    grads = inject_gradients(grads, byz, key)\n"
        '    w = selection_weights("mda", d2_of(grads), 1)\n'
        "    g_hat = w @ grads\n"
        "    return SimState(params=state.params - 0.01 * g_hat)\n")),
    "taint-closure-tree-map": (["REPRO-TAINT-BYZ"], _taint(
        "def make_step(byz):\n"
        "    def step(state, grads, key):\n"
        "        bad = inject_gradients(grads, byz, key)\n"
        "        avg = tree_map(lambda g: g.mean(0), bad)\n"
        "        return state._replace(params=avg)\n"
        "    return step\n")),
    "taint-checkpoint-save": (["REPRO-TAINT-BYZ"], _taint(
        "def snapshot(ckpt_dir, state, spec, key):\n"
        "    corrupted = inject_models(state.params, spec, key)\n"
        "    save(ckpt_dir, 0, corrupted)\n")),
    "taint-corrupt-suppressed": (["REPRO-TAINT-BYZ", "REPRO-SUPPRESS"],
                                 _taint(
        "def poison(pool, spec, state):\n"
        "    bad = pool.corrupt(spec)\n"
        "    # analyze: ignore[REPRO-TAINT-BYZ] fixture: a filter guards it\n"
        "    return state._replace(w_model=bad)\n")),
    # REPRO-DETERMINISM (set order, unsorted digests)
    "det-set-loop": (["REPRO-DETERMINISM"], {
        "m.py": "def manifest(names):\n    out = []\n"
                "    for n in {{x for x in names}}:\n        out.append(n)\n"
                "    return out\n"}),
    "det-set-reduction": (["REPRO-DETERMINISM"], {
        "m.py": "def total(xs):\n    return sum(set(xs))\n"}),
    "det-json-digest": (["REPRO-DETERMINISM"], {
        "m.py": "def cache_key(cfg):\n    return hashlib.sha256("
                "json.dumps(cfg).encode()).hexdigest()\n"}),
    "det-clean": (["REPRO-DETERMINISM"], {
        "m.py": "def manifest(names):\n"
                "    return [n for n in sorted(set(names))]\n"
                "def cache_key(cfg):\n"
                "    blob = json.dumps(cfg, sort_keys=True)\n"
                "    return hashlib.sha256(blob.encode()).hexdigest()\n"
                "def write(doc, f):\n    json.dump(doc, f, indent=1)\n"}),
    # REPRO-AGG-PARITY, the parts the CUDA re-aim leaves as they were
    "agg-parity-wiring": (["REPRO-AGG-PARITY"], {
        "agg/registry.py":
            "register(Aggregator(name='median', requires=(2, 1),\n"
            "    masked_fn=rules.masked_gone))\n"
            "def markdown_table():\n    return [s for s in names()]\n",
        "agg/rules.py": "def masked_coordinate_median(x, m):\n    return x\n",
        "agg/__main__.py": "print(1)\n"}),
    # suppression mechanics
    "suppress-justified": (["REPRO-DETERMINISM", "REPRO-SUPPRESS"], {
        "m.py": "def f(xs):\n"
                "    return sum(set(xs))  "
                "# analyze: ignore[REPRO-DETERMINISM] fixture for docs\n"}),
    "suppress-bare": (["REPRO-DETERMINISM", "REPRO-SUPPRESS"], {
        "m.py": "def f(xs):\n"
                "    return sum(set(xs))  "
                "# analyze: ignore[REPRO-DETERMINISM]\n"}),
    "suppress-line-above": (["REPRO-DETERMINISM", "REPRO-SUPPRESS"], {
        "m.py": "def f(xs):\n"
                "    # analyze: ignore[REPRO-DETERMINISM] fixture\n"
                "    return sum(set(xs))\n"}),
    "suppress-in-string": (["REPRO-DETERMINISM", "REPRO-SUPPRESS"], {
        "m.py": 'MSG = "analyze: ignore[REPRO-DETERMINISM] nope"\n'
                "def f(xs):\n    return sum(set(xs))\n"}),
    "suppress-repo-scope": (["REPRO-MEMBERSHIP-FLOOR", "REPRO-SUPPRESS"], {
        "exp/presets.py":
            "# analyze: ignore[REPRO-MEMBERSHIP-FLOOR] floor fixture\n"
            + BAD_PRESET, "exp/spec.py": "{spec}"}),
    "suppress-repo-scope-bare": (["REPRO-MEMBERSHIP-FLOOR",
                                  "REPRO-SUPPRESS"], {
        "exp/presets.py": "# analyze: ignore[REPRO-MEMBERSHIP-FLOOR]\n"
                          + BAD_PRESET, "exp/spec.py": "{spec}"}),
    "parse-error": (["REPRO-PARSE"], {"m.py": "def broken(:\n"}),
}


def _write_tree(tmp_path, files: dict) -> None:
    for key, pkg in PKGS.items():
        for rel, text in files.items():
            path = tmp_path / "src" / pkg / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            spec = _spec_src(pkg) if text == "{spec}" else None
            path.write_text(spec or text.format(pkg=pkg))
    (tmp_path / "tests").mkdir(exist_ok=True)
    for name in ("test_agg.py", "test_torch_agg.py"):
        (tmp_path / "tests" / name).write_text("NAMES = ['median']\n")


def to_port(s: str) -> str:
    """A reference path or message in the port's terms."""
    s = s.replace(os.path.join("src", "repro", ""),
                  os.path.join("src", "repro_torch", ""))
    s = s.replace("tests/test_agg.py", "tests/test_torch_agg.py")
    return re.sub(r"\brepro\.(?=\w)", "repro_torch.", s)


def _view(found, ids):
    return sorted((f.rule_id, f.path, f.line, f.message) for f in found
                  if f.rule_id in ids)


@pytest.mark.parametrize("name", sorted(PARITY))
def test_carried_rules_match_the_reference(tmp_path, name):
    ids, files = PARITY[name]
    _write_tree(tmp_path, files)
    ref = _view(ref_analyze.lint_repo(str(tmp_path)), ids)
    port = _view(port_analyze.lint_repo(str(tmp_path)), ids)
    assert port == [(r, to_port(p), ln, to_port(m)) for r, p, ln, m in ref]
    if name.endswith(("bad-cluster", "bypass", "orphan", "-bare",
                      "set-loop", "json-digest", "parse-error",
                      "below-two", "wiring")):
        assert port, "a tripping fixture found nothing"


def test_taint_policy_matches_the_reference_on_the_live_registries():
    from repro.analyze.rules import taint_byz as ref_taint
    from repro_torch.analyze.rules import taint_byz as port_taint
    ref = ref_taint.registry_policy(ROOT)
    port = port_taint.registry_policy(ROOT)
    assert port.robust_rules == ref.robust_rules
    assert port.all_rules == ref.all_rules
    assert "mean" not in port.sanitizers and "mean" in port.all_rules


@pytest.mark.parametrize("case", ["roundtrip", "refresh"])
def test_baseline_mechanics_match_the_reference(tmp_path, case):
    """The same findings through both packages' baseline code give the same
    keys (the port's entries also carry a reason)."""
    out = {}
    for key, F in (("ref", ref_findings), ("port", port_findings)):
        d = tmp_path / key
        d.mkdir()
        f1 = F.Finding("REPRO-DEAD-SEED", "a.py", 3, "dead")
        f2 = F.Finding("REPRO-DETERMINISM", "b.py", 9, "set order")
        path = str(d / "baseline.json")
        if case == "roundtrip":
            F.write_baseline([f1], path)
            base = F.load_baseline(path)
            new, known = F.split_baselined([f1, f2], base)
            moved = F.Finding("REPRO-DEAD-SEED", "a.py", 99, "dead").key
            out[key] = ([f.key for f in new], [f.key for f in known],
                        moved in base)
        else:
            (d / "src").mkdir()
            (d / "src" / "kept.py").write_text("")
            stale = F.Finding("REPRO-GONE", "src/kept.py", 0, "x")
            gone = F.Finding("REPRO-DEAD-SEED", "src/deleted.py", 0, "y")
            kept = F.Finding("REPRO-DEAD-SEED", "src/kept.py", 0, "z")
            F.write_baseline([stale, gone, kept], path)
            _, pruned = F.refresh_baseline(
                [f2], path, str(d), {"file", "repo"},
                {"REPRO-DEAD-SEED": "repo", "REPRO-DETERMINISM": "file"})
            out[key] = (sorted(pruned), sorted(F.load_baseline(path)))
    assert out["port"] == out["ref"]


def test_port_baseline_entries_keep_their_reason(tmp_path):
    f = port_findings.Finding("REPRO-DEAD-SEED", "src/a.py", 0, "dead")
    path = str(tmp_path / "baseline.json")
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "a.py").write_text("")
    port_findings.write_baseline([f], path)
    with open(path) as fh:
        doc = json.load(fh)
    doc["findings"][0]["reason"] = "tracked"
    with open(path, "w") as fh:
        json.dump(doc, fh)
    port_findings.refresh_baseline([f], path, str(tmp_path), {"repo"},
                                   {"REPRO-DEAD-SEED": "repo"})
    assert port_findings.load_entries(path)[0]["reason"] == "tracked"


# ---------------------------------------------------------------------------
# the CUDA-source audit and the build key
# ---------------------------------------------------------------------------

GRID_SRC = """\
#include <cuda_runtime.h>
__global__ void k(const float* x, float* out, long long d) {{
  const long long col = (long long)blockIdx.x * 64 + threadIdx.x;
  {guard}
  out[col] = x[col];
}}
extern "C" int run(const float* x, float* out, long long d) {{
  {check}
  k<<<{grid}, 64>>>(x, out, d);
  return 0;
}}
"""


def cuda_hits(tmp_path, files: dict, rule: str):
    csrc = tmp_path / "src" / "repro_torch" / "kernels" / "fake" / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for name, text in files.items():
        (csrc / name).write_text(text)
    return [f for f in port_analyze.get(rule).check(str(tmp_path))]


def _grid(grid="(d + 63) / 64", guard="if (col >= d) return;", check=""):
    return GRID_SRC.format(grid=grid, guard=guard, check=check)


@pytest.mark.parametrize("rule,src,trips", [
    ("REPRO-CUDA-GRID", _grid(grid="d / 64"), True),
    ("REPRO-CUDA-GRID", _grid(), False),
    ("REPRO-CUDA-GRID", _grid(grid="(d + 64 - 1) / 64"), False),
    ("REPRO-CUDA-GRID", _grid(grid="d / 64",
                              check="if (d % 64 != 0) return 1;"), False),
    ("REPRO-CUDA-GUARD", _grid(guard=""), True),
    ("REPRO-CUDA-GUARD", _grid(), False),
    ("REPRO-CUDA-GUARD", _grid(guard="", grid="d / 64"), False),
], ids=["grid-floor-div", "grid-ceil-div", "grid-ceil-div-spelled",
        "grid-evidence", "guard-missing", "guard-early-return",
        "guard-exact-grid"])
def test_cuda_grid_and_guard(tmp_path, rule, src, trips):
    found = cuda_hits(tmp_path, {"k.cu": src}, rule)
    assert bool(found) == trips, found
    if trips:
        assert found[0].path.endswith("k.cu")
        assert found[0].line == (9 if rule == "REPRO-CUDA-GRID" else 5)


ACC_SRC = """\
#include <cuda_bf16.h>
__global__ void k(__nv_bfloat16* out, const float* x, int n) {{
  {body}
}}
__device__ void mma(float (&d)[32], unsigned long long a) {{
  asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.{acc}.bf16.bf16 "
               "{{%0}}, %1;" : "+f"(d[0]) : "l"(a));
}}
"""


@pytest.mark.parametrize("body,acc,trips", [
    ("out[threadIdx.x] += __float2bfloat16(x[threadIdx.x]);", "f32", True),
    ("__nv_bfloat16 s = out[0];\n  s += out[1];\n  out[0] = s;", "f32", True),
    ("float s = 0.f;\n  s += x[0];\n  out[0] = __float2bfloat16(s);", "f16",
     True),
    ("float s = 0.f;\n  s += x[0];\n  out[0] = __float2bfloat16(s);", "f32",
     False),
], ids=["bf16-array", "bf16-scalar", "wgmma-f16", "f32"])
def test_cuda_acc(tmp_path, body, acc, trips):
    found = cuda_hits(tmp_path, {"k.cu": ACC_SRC.format(body=body, acc=acc)},
                      "REPRO-CUDA-ACC")
    assert bool(found) == trips, found


MASK_SRC = """\
#include "net.cuh"
__global__ void k(const float* x, float* out, int n, long long d) {{
  const long long col = (long long)blockIdx.x * 64 + threadIdx.x;
  if (col >= d) return;
  float r[8];
  {load}
  sort_bitonic<8>(r);
  out[col] = r[3];
}}
"""
NET = """\
constexpr float BIG = 3.4e38f;
template <int N> __device__ void sort_bitonic(float* r) {
  for (int i = 0; i < N; ++i) r[i] = fminf(r[i], r[(i + 1) % N]);
}
__device__ void load_clean(const float* x, float* r, int n, long long d,
                           long long col) {
  for (int i = 0; i < 8; ++i) {
    float v = i < n ? x[i * d + col] : BIG;
    if (isnan(v)) v = BIG;
    r[i] = v;
  }
}
"""


@pytest.mark.parametrize("load,trips", [
    ("for (int i = 0; i < 8; ++i) r[i] = x[i * d + col];", True),
    ("for (int i = 0; i < 8; ++i) { float v = x[i * d + col]; "
     "if (isnan(v)) v = BIG; r[i] = v; }", False),
    ("load_clean(x, r, n, d, col);", False),
], ids=["no-sentinel", "inline-sentinel", "helper-sentinel"])
def test_cuda_mask(tmp_path, load, trips):
    found = cuda_hits(tmp_path, {"k.cu": MASK_SRC.format(load=load),
                                 "net.cuh": NET}, "REPRO-CUDA-MASK")
    assert bool(found) == trips, found
    if trips:
        assert found[0].line == 7


BUILD = """\
from pathlib import Path
_HERE = Path(__file__).resolve().parent
SOURCES = {{
    "fake": _HERE / "fake" / "csrc" / "k.cu",
}}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code={arch}", "-O3")
"""


@pytest.mark.parametrize("case", ["clean", "outside-include",
                                  "missing-include", "unlisted-source",
                                  "wrong-arch"])
def test_build_key(tmp_path, case):
    kdir = tmp_path / "src" / "repro_torch" / "kernels"
    csrc = kdir / "fake" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text('#include "h.cuh"\n'
                               + ('#include "../../common.cuh"\n'
                                  if case == "outside-include" else "")
                               + ('#include "gone.cuh"\n'
                                  if case == "missing-include" else ""))
    (csrc / "h.cuh").write_text("// header\n")
    (kdir / "common.cuh").write_text("// shared\n")
    if case == "unlisted-source":
        (csrc / "extra.cu").write_text("// never built\n")
    (kdir / "_build.py").write_text(BUILD.format(
        arch="sm_90" if case == "wrong-arch" else "sm_90a"))
    found = build_key.check(str(tmp_path))
    if case == "clean":
        assert found == []
    else:
        assert len(found) == 1, found
        assert {"outside-include": "does not resolve",
                "missing-include": "does not resolve",
                "unlisted-source": "not in _build.SOURCES",
                "wrong-arch": "sm_90a"}[case] in found[0].message


def test_live_cuda_sources_audit_clean():
    units = cuda_audit.units(ROOT)
    assert len(units) == 6                 # one per _build.SOURCES entry
    assert sum(len(u) for u in units) >= 9  # their headers came along
    launched = set().union(*(cuda_audit._ceil_launched(u) for u in units))
    assert {"order_stat_kernel", "meamed_exact_kernel", "fwd_kernel",
            "dq_kernel", "dkv_kernel", "state_scan_fwd_kernel",
            "state_scan_bwd_kernel"} <= launched
    for rule in ("REPRO-CUDA-GRID", "REPRO-CUDA-GUARD", "REPRO-CUDA-ACC",
                 "REPRO-CUDA-MASK", "REPRO-BUILD-KEY"):
        assert port_analyze.get(rule).check(ROOT) == [], rule


# ---------------------------------------------------------------------------
# the generator rule, the strict environment rule, the step-rooted sync rule
# ---------------------------------------------------------------------------


def file_hits(check, src: str, path="src/repro_torch/m.py"):
    import ast
    return check(ast.parse(src), src, path)


@pytest.mark.parametrize("src,trips", [
    ("x = torch.randn((3, 4))\n", True),
    ("def f(n):\n    return torch.randperm(n)\n", True),
    ("def f(p):\n    return torch.bernoulli(p)\n", True),
    ("x = torch.randn((3, 4), generator=gen, device=gen.device)\n", False),
    ("def f(p, g):\n    return torch.multinomial(p, 2, generator=g)\n",
     False),
    ("x = torch.zeros(3)\n", False),
])
def test_generator_rule(src, trips):
    found = [f for f in file_hits(determinism.check, src)
             if "generator" in f.message]
    assert bool(found) == trips, found


@pytest.mark.parametrize("src,trips", [
    ('def f():\n    return os.environ.get("REPRO_AGG_BACKEND")\n', True),
    ('X = os.getenv("REPRO_X", "1")\n', True),
    ('def f():\n    return os.environ["HOME"]\n', True),
    ('def f():\n    os.environ["WORLD_SIZE"] = "2"\n', True),
    ('def f():\n    os.environ.pop("RANK", None)\n', True),
    ('def f(k):\n    return os.environ.get(k)\n', True),
    ('def f():\n    env = os.environ\n    return env.get("REPRO_F")\n', True),
    ('def f():\n    env = os.environ\n    return int(env.get("RANK", 0))\n',
     False),
    ('def f():\n    return os.environ.get("CUDA_HOME", "/usr/local/cuda")\n',
     False),
    ('def f():\n    return int(os.environ.get("WORLD_SIZE", 1))\n', False),
    ("def f(d):\n    return d.get('REPRO_X')\n", False),
])
def test_strict_env_rule(src, trips):
    found = file_hits(env_hygiene.check, src)
    assert bool(found) == trips, found
    assert all(f.rule_id == "REPRO-ENV" for f in found)


ENGINE_SRC = """\
from .helpers import reduce_all


class EpochEngine:
    def __init__(self, sim):
        self.step = make_step(sim)

    def run_epoch(self, state, batches, bufs, at):
        for i in range(batches.shape[0]):
            state = self.step(state, batches[i])
            bufs["n"][at + i] = reduce_all(state)
        return state

    def run(self, state, batches):
        state = self.run_epoch(state, batches, {{}}, 0)
        return state, float(state.sum())


def make_step(sim):
    def step(state, batch):
        {step_body}
        return state + batch

    return step
"""
HELPERS_SRC = """\
def reduce_all(x):
    {helper_body}
    return x.sum()


def elsewhere(x):
    return x.item()
"""


@pytest.mark.parametrize("step_body,helper_body,where", [
    ("pass", "pass", None),
    ("n = int(state.abs().max())", "pass", ("engine.py", 21)),
    ("pass", "torch.cuda.synchronize()", ("helpers.py", 2)),
    ("pass", "v = x.tolist()", ("helpers.py", 2)),
    ("k = int(batch.shape[0])", "ok = bool(len(x))", None),
])
def test_host_sync_follows_the_step_closure(tmp_path, step_body,
                                            helper_body, where):
    core = tmp_path / "src" / "repro_torch" / "core"
    core.mkdir(parents=True)
    (core / "engine.py").write_text(ENGINE_SRC.format(step_body=step_body))
    (core / "helpers.py").write_text(HELPERS_SRC.format(
        helper_body=helper_body))
    found = host_sync.check(str(tmp_path))
    # run() and elsewhere() are outside the closure: never flagged
    assert [(os.path.basename(f.path), f.line) for f in found] == (
        [where] if where else [])


def test_host_sync_reports_missing_roots(tmp_path):
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    found = host_sync.check(str(tmp_path))
    assert len(found) == 1 and "no step loop" in found[0].message


# ---------------------------------------------------------------------------
# the live tree, the CLI, the README
# ---------------------------------------------------------------------------


def test_cli_run_is_clean_modulo_the_baseline(tmp_path, capsys):
    """Layers 1 and 2 in one call: exit 0, every file/repo/run rule run,
    the violations empty and only baselined findings left."""
    from repro_torch.analyze.__main__ import main
    report = str(tmp_path / "report.json")
    rc = main(["--run", "--json", report, "--root", ROOT])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "clean" in out
    with open(report) as f:
        doc = json.load(f)
    assert doc["clean"] and doc["violations"] == []
    want = {r.rule_id for r in port_rules() if r.scope != "card"}
    assert set(doc["stats"]["rules_run"]) == want
    assert doc["provenance"]["torch_version"] == torch.__version__
    base = port_findings.load_baseline(
        os.path.join(ROOT, port_findings.BASELINE_PATH))
    assert {f"{v['rule_id']}::{v['path']}::{v['message']}"
            for v in doc["baselined"]} <= base


def test_committed_baseline_entries_carry_reasons_and_stand_in_roadmap():
    entries = port_findings.load_entries(
        os.path.join(ROOT, port_findings.BASELINE_PATH))
    assert entries
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read()
    for e in entries:
        assert e["reason"].strip(), e["key"]
        rule, path, _ = e["key"].split("::", 2)
        assert f"`{rule}`" in roadmap and os.path.basename(path) in roadmap, \
            e["key"]


def test_live_taint_needs_only_the_explained_suppression():
    """The protocol lints clean on merit; the simulator's sync variant
    carries the reference's one justified suppression (Algorithm 3's
    filters guard the w_model write), which lint_repo honours."""
    from repro_torch.analyze.rules import taint_byz
    sim = os.path.join("src", "repro_torch", "core", "simulator.py")
    raw = taint_byz.check(ROOT)
    assert [f.path for f in raw] == [sim]
    assert "_replace(w_model=...)" in raw[0].message
    with open(os.path.join(ROOT, sim)) as f:
        lines = f.read().splitlines()
    assert "ignore[REPRO-TAINT-BYZ] Alg. 3" in lines[raw[0].line - 2]
    sups, bad = port_findings.scan_suppressions("\n".join(lines), sim)
    assert not bad and port_findings.is_suppressed(raw[0], sups)


def test_run_inplace_trips_on_a_rebound_state_tensor(monkeypatch):
    from repro_torch.core.protocol import ProtocolEngine
    real = ProtocolEngine.run_epoch

    def rebinding(self, state, batches, bufs, at):
        state = real(self, state, batches, bufs, at)
        return state._replace(params=state.params.clone())

    monkeypatch.setattr(ProtocolEngine, "run_epoch", rebinding)
    found = [f for f in port_run.check_inplace(ROOT)
             if f.path.endswith("protocol.py")]
    assert [f.message.split(":")[0] for f in found] == [
        "protocol[naive] run_epoch", "protocol[sharded] run_epoch"]
    assert all("params took a new storage" in f.message for f in found)


def test_storages_walk_nested_state():
    a, b = torch.zeros(3), torch.zeros(2, 2)
    before = port_run.storages({"x": (a, [b]), "s": torch.tensor(1.0)})
    assert set(before) == {"x[0]", "x[1][0]"}       # 0-d scalars exempt
    after = port_run.storages({"x": (a, [b.clone()])})
    assert port_run.moved(before, after) == ["x[1][0]"]


def test_card_layer_raises_without_a_card():
    from repro_torch.analyze import card
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --card would run for real")
    with pytest.raises(RuntimeError, match="CUDA"):
        card.measure("cuda")


def test_rule_table_covers_every_layer_and_stands_in_readme():
    ids = {r.rule_id for r in port_rules()}
    assert {"REPRO-HOST-SYNC", "REPRO-ENV", "REPRO-BYZ-BOUNDS",
            "REPRO-AGG-PARITY", "REPRO-MEMBERSHIP-FLOOR", "REPRO-TAINT-BYZ",
            "REPRO-DETERMINISM", "REPRO-DEAD-SEED", "REPRO-CUDA-GRID",
            "REPRO-CUDA-GUARD", "REPRO-CUDA-ACC", "REPRO-CUDA-MASK",
            "REPRO-BUILD-KEY", "REPRO-RUN-INPLACE", "REPRO-RUN-COLLECTIVES",
            "REPRO-CARD-HOST-TRANSFER"} == ids
    table = port_analyze.markdown_table()
    with open(os.path.join(ROOT, "README.md")) as f:
        readme = f.read()
    assert table in readme
    assert ref_analyze.markdown_table() in readme
    assert "REPRO-HLO-RECOMPILE" in table          # the not-ported notes


def test_lint_roots_are_the_ports_own_code():
    paths = {os.path.relpath(p, ROOT) for p in port_analyze.lint_paths(ROOT)}
    assert "chip_smoke.py" in paths
    assert any(p.startswith("tools" + os.sep) for p in paths)
    assert os.path.join("src", "repro_torch", "analyze", "astlint.py") in paths
    assert not any(p.startswith(os.path.join("src", "repro", ""))
                   or p.startswith(("tests", "benchmarks", "examples"))
                   for p in paths)


def test_cli_table_via_python_m():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analyze",
                          "--table"], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == port_analyze.markdown_table()


# ---------------------------------------------------------------------------
# models/layers.whole_leaves: one gather a dtype, in a fixed order
# ---------------------------------------------------------------------------


class _TP:
    M = 2


@pytest.mark.parametrize("order", [("float32", "bfloat16", "float16"),
                                   ("bfloat16", "float16", "float32")])
def test_whole_leaves_gathers_in_dtype_name_order(monkeypatch, order):
    from repro_torch.models import layers
    from repro_torch.models import sharding as shr
    seen = []

    def gather(x, tp, dim, tag):
        seen.append((x.dtype, tag))
        return torch.cat([x, x + 1], dim=0)       # rank 0's, then rank 1's

    monkeypatch.setattr(shr, "active", lambda: _TP())
    monkeypatch.setattr(shr, "gather_from_model", gather)
    p, shapes = {"blk": {}}, {}
    for i, name in enumerate(order):
        dt = getattr(torch, name)
        p["blk"][f"w{i}"] = torch.arange(3, dtype=torch.float32).to(dt)
        shapes[f"blk/w{i}"] = (6,)
    p["blk"]["whole"] = torch.ones(4)
    shapes["blk/whole"] = (4,)
    out = layers.whole_leaves(p, shapes)
    assert [d for d, _ in seen] == sorted((getattr(torch, n) for n in order),
                                          key=str)
    assert {t for _, t in seen} == {"model_leaves"}
    for i, name in enumerate(order):
        w = out["blk"][f"w{i}"]
        assert w.dtype == getattr(torch, name) and w.shape == (6,)
        assert w.float().tolist() == [0, 1, 2, 1, 2, 3]
    assert out["blk"]["whole"] is p["blk"]["whole"]
