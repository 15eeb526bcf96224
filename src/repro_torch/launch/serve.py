"""Batched serving launcher (port of ``repro.launch.serve``): prefill and
greedy decode of one random prompt batch. Three model sources, by flag:

  * default — random init from a seed, in bf16, one serving model;
  * ``--ckpt-dir`` — restore a replica-stacked ByzSGD checkpoint and take
    the coordinate-wise median of the replicas (a Byzantine replica is
    outvoted at load time), cast to bf16;
  * ``--ckpt-dir --quorum`` — keep every restored replica live behind
    :class:`repro_torch.serve.QuorumService` with f = (R - 1) // 3: every
    token is a quorum read.

  python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --batch 4 --prefill 64 --decode 32

``--arch`` takes every arch of the reference (``models.registry.ARCH_IDS``)
and the port's own (``PORT_ONLY_IDS``: granite-4.0-h-micro);
the decode steps the B rows together (a MoE routes them as one group, as
the JAX driver does). The vlm family (qwen2-vl-7b) prefills merged
embeddings at ``[3, B, S]`` M-RoPE ids and decodes the last embedding at
ids one further each step; the audio family (whisper-small) prefills the
batch's encoder frames with its tokens and decodes by token, as the JAX
driver does. Runs on the GPU; ``--device cpu`` (with ``--reduced``) is for
smoke runs.

``--mesh DxM`` serves on a ('data', 'model') mesh of D x M
``torch.distributed`` ranks (``torchrun --nproc-per-node D*M``), as the
reference's launcher does on its device mesh: the batch rows split over
'data' where they divide (:func:`repro_torch.launch.steps.
batch_sharding`), each leaf's block over 'model'
(:func:`~repro_torch.launch.steps.serve_param_sharding`: tensor
parallelism, every family) and, past 4 GB a rank, over
'data' too (ZeRO: a layer's leaves gathered at use), the decode cache's
chunks over 'model' (:func:`~repro_torch.launch.steps.cache_sharding`); a
checkpoint is restored and consolidated whole on every rank, then cut.
Rank 0 prints. A run that joined a process group leaves it on every exit
(:func:`~repro_torch.launch.mesh.leaving_group`).

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
      --reduced --device cpu --batch 2 --prefill 16 --decode 4 --mesh 2x2
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from ..core.simulator import FlatTree
from ..models import layers as L
from ..models import sharding as shr
from ..models.registry import ALL_IDS, get_bundle
from . import steps
from .mesh import launch_mesh, leaving_group, make_mesh, make_serve_mesh


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def decode_batch(bundle, prefill_batch, tok, i: int) -> dict:
    """Decode step ``i``'s input: the last token, or for the vlm family the
    prefill's last embedding at its last M-RoPE ids + i + 1 (no vision
    frontend turns a token back into an embedding)."""
    if bundle.cfg.family == "vlm":
        return {"embeds": prefill_batch["embeds"][:, -1:],
                "positions": prefill_batch["positions"][:, :, -1:] + i + 1}
    return {"token": tok}


def _serve_quorum(args, bundle, pool, dev, rules=None) -> dict:
    """--quorum: every restored replica live, every token a quorum read."""
    from ..serve import QuorumService
    B, S = args.batch, args.prefill
    # the cache splits into 4 chunks: round its length up to a multiple
    svc = QuorumService(pool, bundle, n_slots=B,
                        max_len=-(-(S + args.decode + 1) // 4) * 4,
                        rules=rules)
    pf = bundle.make_batch("prefill", B, S,
                           torch.Generator(device=dev).manual_seed(1))
    prompts = [row.tolist() for row in pf["tokens"].cpu()]
    t0 = time.perf_counter()
    with torch.inference_mode():
        outs = svc.generate(prompts, max_new=args.decode)
    _sync(dev)
    wall = time.perf_counter() - t0
    rep = svc.report()
    if rules is not None and rules.mesh.rank:
        return rep
    print(f"[serve] quorum ({rep['rule']}): {rep['committed_tokens']} tokens "
          f"across {rep['n_replicas']} replicas (f={rep['f']}, "
          f"{rep['n_active']} active) in {wall:.2f}s "
          f"({rep['tok_s']:.1f} tok/s) | disagreement "
          f"{rep['disagreement_rate']:.4f} | ejections {rep['ejections']} | "
          f"retries {rep['retries']}")
    print(f"[serve] sample continuation ids: {outs[0][:10]}")
    return rep


def main(argv=None, stats: dict | None = None):
    """Run the launcher on ``argv``. Returns the generated ids ``[B, 1 +
    decode]`` (the quorum report with ``--quorum``); a ``stats`` dict, when
    given, receives the prefill and decode seconds, the decode tok/s and
    the prefill's last-token logits of this rank's rows (``logits``,
    float32 on the host, joined over 'model')."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b", choices=ALL_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--depth", type=int, default=None,
                    help="keep the arch's width, cut its depth")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prefill", type=int, default=64)
    ap.add_argument("--decode", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore + median-consolidate a ByzSGD checkpoint")
    ap.add_argument("--quorum", action="store_true",
                    help="with --ckpt-dir: serve every restored replica "
                         "behind quorum reads instead of consolidating")
    ap.add_argument("--mesh", default=None,
                    help="DxM data x model ranks (torchrun); default 1x1")
    args = ap.parse_args(argv)
    if args.quorum and not args.ckpt_dir:
        raise SystemExit("--quorum serves the replicas of a checkpoint: "
                         "pass --ckpt-dir")

    bundle = get_bundle(args.arch, reduced=args.reduced, depth=args.depth)
    with leaving_group():
        return _serve(args, bundle, stats)


def _serve(args, bundle, stats):
    dev, smesh = _mesh(args, bundle.cfg)
    rules = steps.serve_rules(smesh, bundle.cfg) if smesh else None
    lead = smesh is None or smesh.rank == 0
    if args.ckpt_dir:
        from ..serve import ReplicaPool, checkpoint_groups
        from ..serve.replica import tree_map
        step, R = checkpoint_groups(args.ckpt_dir)
        f = (R - 1) // 3   # the protocol's server tolerance for R groups
        pool = ReplicaPool.from_checkpoint(args.ckpt_dir, bundle.init,
                                           step=step, f=f, device=dev)
        if lead:
            print(f"[serve] restored step {step}: {R} replicas (f={f}) "
                  f"from {args.ckpt_dir}")
        if args.quorum:
            return _serve_quorum(args, bundle, pool, dev, rules)
        with torch.inference_mode():
            params = tree_map(lambda l: l.to(torch.bfloat16)
                              if l.dtype == torch.float32 else l,
                              pool.consolidated())
        del pool
        if lead:
            print("[serve] median-consolidated to one serving model")
    else:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = bundle.init(gen, dtype=torch.bfloat16)
    if smesh is not None:
        params = _cut_params(params, smesh, bundle.cfg)

    B, S = args.batch, args.prefill
    max_len = S + args.decode + 1
    pf = bundle.make_batch("prefill", B, S,
                           torch.Generator(device=dev).manual_seed(1))
    if smesh is not None:
        pf = {k: steps.block(v, steps.batch_sharding(k, v.shape, smesh),
                             smesh) for k, v in pf.items()}
    Bl = next(v for k, v in pf.items() if k != "positions").shape[0]

    with torch.inference_mode(), shr.sharding_rules(rules):
        caches = bundle.init_caches(Bl, max_len=max_len,
                                    n_chunks=smesh.size("model")
                                    if smesh else 1, device=dev)
        t0 = time.perf_counter()
        logits, caches = bundle.prefill(params, pf, caches)
        _sync(dev)
        t_pf = time.perf_counter() - t0
        tok = L.argmax_vocab(logits)[:, None]
        if stats is not None:
            stats["logits"] = L.gather_vocab(logits).float().cpu()
        out_tokens = [tok]
        t0 = time.perf_counter()
        for i in range(args.decode):
            logits, caches = bundle.decode(params, caches,
                                           decode_batch(bundle, pf, tok, i))
            tok = L.argmax_vocab(logits)[:, None]
            out_tokens.append(tok)
        _sync(dev)
        t_dec = time.perf_counter() - t0
    out = torch.cat(out_tokens, dim=1)
    if smesh is not None and Bl < B:
        out = smesh.all_gather(out, "data", "serve")
    total = B * args.decode
    if stats is not None:
        stats.update(prefill_s=t_pf, decode_s=t_dec,
                     tok_s=total / max(t_dec, 1e-9))
    if not lead:
        return out
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    if smesh is not None:
        where += f", mesh {smesh.sizes}"
    print(f"[serve] {args.arch}: prefill {B}x{S} in {t_pf:.2f}s | "
          f"decode {args.decode} steps x batch {B} = {total} tokens in "
          f"{t_dec:.2f}s ({total / max(t_dec, 1e-9):.1f} tok/s on {where})")
    print(f"[serve] sample continuation ids: {out[0, :10].tolist()}")
    return out


def _mesh(args, cfg):
    """(this rank's device, the serve mesh or ``None`` on one rank) of
    ``--mesh`` over the ranks ``torchrun`` started."""
    dev, d, m = launch_mesh(args.mesh, args.device, cfg)
    if d * m == 1 and not dist.is_initialized():
        return dev, None
    return dev, make_serve_mesh(make_mesh((d, m), ("data", "model")))


class _Zero:
    """A serving leaf split over 'data' as well (ZeRO): this rank's block,
    gathered over 'data' at use — whole (``whole``), or one layer's slice
    of a stacked ``[L, ...]`` leaf at a time (``leaf[i]``, as
    ``transformer.layer`` takes it: from the rank that holds layer i when
    the layer dim is the one split)."""

    def __init__(self, block: torch.Tensor, dim: int, mesh):
        self.block, self.dim, self.mesh = block, dim, mesh

    def _join(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        parts = self.mesh.all_gather(x.contiguous()[None], "data", "zero")
        return torch.cat(list(parts.unbind(0)), dim=dim)

    def whole(self) -> torch.Tensor:
        return self._join(self.block, self.dim)

    def __getitem__(self, i: int) -> torch.Tensor:
        if self.dim > 0:
            return self._join(self.block[i], self.dim - 1)
        n = self.block.shape[0]
        x = (self.block[i % n].clone() if self.mesh.coord("data") == i // n
             else torch.empty_like(self.block[0]))
        return self.mesh.broadcast(x, "data", "zero", src=i // n)


class _ZeroTree(dict):
    """A params dict whose ZeRO leaves are gathered whole when read by key
    (``p["table"]``); ``transformer.layer`` walks ``items()`` and takes
    each stacked leaf's layer slice itself."""

    def __getitem__(self, k):
        v = dict.__getitem__(self, k)
        return v.whole() if isinstance(v, _Zero) else v


def _cut_params(params, smesh, cfg):
    """This rank's blocks of a whole serving model (copies, so the whole
    can be freed), by :func:`~repro_torch.launch.steps.
    serve_param_sharding`: 'model' blocks, and where a rank would hold
    more than 4 GB of them, ZeRO blocks over 'data' (:class:`_Zero`)."""
    tree = FlatTree.from_params(params)
    specs = steps.serve_param_sharding(tree, smesh, cfg)
    out: dict = _ZeroTree()
    for path, leaf, spec in zip(tree.paths, tree.leaves(params), specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, _ZeroTree())
        blk = steps.block(leaf, spec, smesh).clone()
        node[path[-1]] = (_Zero(blk, spec["data"], smesh)
                          if "data" in spec and smesh.size("data") > 1
                          else blk)
    return out


if __name__ == "__main__":
    main()
