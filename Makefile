# Convenience lanes around the tier-1 verify command (see ROADMAP.md).
PY      := python
ENV     := PYTHONPATH=src$(if $(PYTHONPATH),:$(PYTHONPATH),)

.PHONY: all tier1 test fast lint lint-fast lint-torch netsim agg-bench bench examples perf exp serve serve-bench elastic-bench

# default: static analysis first (seconds to fail on a repo-invariant
# violation), then the full tier-1 gate
all: lint tier1

# alias so `make test` means the tier-1 gate
test: tier1

# static analysis, both layers: AST repo-invariant lint + compiled-artifact
# audit on a forced 8-device CPU topology. Exits 1 on any violation that is
# neither inline-suppressed nor in results/analyze/baseline.json (committed
# empty — the repo lints clean).
lint:
	$(ENV) $(PY) -m repro.analyze --hlo --json results/analyze/report.json

# layer 1 only, taint scoped to changed-file SCC (jax-free) — pre-commit speed
lint-fast:
	$(ENV) $(PY) -m repro.analyze --fast

# the port's static analysis (repro_torch.analyze): layer 1 (AST, CUDA
# sources, build key) + layer 2 (the smoke preset run on the CPU). Exits 1
# on any violation that is neither inline-suppressed nor in
# results/analyze_torch/baseline.json (each entry with its reason);
# `--card` adds layer 3 on a GPU
lint-torch:
	$(ENV) $(PY) -m repro_torch.analyze --run --json results/analyze_torch/report.json

# full tier-1 gate: everything, stop at first failure
tier1:
	$(ENV) $(PY) -m pytest -x -q

# fast lane: skip the slow subprocess end-to-end drivers
fast:
	$(ENV) $(PY) -m pytest -q -m "not slow"

# netsim subsystem only (tests + benchmark)
netsim:
	$(ENV) $(PY) -m pytest -q tests/test_netsim.py
	$(ENV) $(PY) -m benchmarks.run --only netsim

# aggregator backend timings (jnp vs Pallas per registry rule)
agg-bench:
	$(ENV) $(PY) -m benchmarks.run --only agg

# perf lane: fused-engine throughput benchmark (incl. the protocol_naive /
# protocol_sharded rows on the acceptance config), gated (>25% fused
# steps/sec regression fails) against the committed perf-trajectory baseline
# (which a run never overwrites; refresh it deliberately with
# `python -m benchmarks.exp_throughput --seed-baseline`)
perf:
	$(ENV) $(PY) -m benchmarks.run --only throughput --compare BENCH_throughput.json

# serve subsystem: unit/property tests (incl. the forced-8-device subprocess
# lane) + the quorum-read overhead / Byzantine-correctness benchmark
serve:
	$(ENV) $(PY) -m pytest -q tests/test_serve.py tests/test_serve_distributed.py

serve-bench:
	$(ENV) $(PY) -m benchmarks.run --only serve

# elastic membership: protocol-vs-elastic equivalence (bit-identity asserted),
# churn overhead, and recovery-time-to-parity after a G 5->4->5 cycle
elastic-bench:
	$(ENV) $(PY) -m benchmarks.run --only elastic

# experiment-API smoke lane: one spec through all four runners (stepwise
# oracle, fused engine, netsim trace, distributed protocol on a 1-device
# mesh), results + provenance under results/benchmarks/exp_smoke_*.json
exp:
	$(ENV) $(PY) -m benchmarks.run --exp smoke --runners stepwise,fused,netsim,protocol

bench:
	$(ENV) $(PY) -m benchmarks.run

examples:
	$(ENV) $(PY) examples/netsim_scenarios.py --steps 20
