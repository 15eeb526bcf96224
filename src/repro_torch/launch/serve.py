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

``--arch`` takes every arch of the reference (``models.registry.ARCH_IDS``);
the decode steps the B rows together (a MoE routes them as one group, as
the JAX driver does). The vlm family (qwen2-vl-7b) prefills merged
embeddings at ``[3, B, S]`` M-RoPE ids and decodes the last embedding at
ids one further each step; the audio family (whisper-small) prefills the
batch's encoder frames with its tokens and decodes by token, as the JAX
driver does. Runs on the GPU; ``--device cpu`` (with ``--reduced``) is for
smoke runs.
The TPU mesh (``--mesh``) has no counterpart on one card.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import device as devmod
from ..models.registry import ARCH_IDS, get_bundle


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


def _serve_quorum(args, bundle, pool, dev) -> dict:
    """--quorum: every restored replica live, every token a quorum read."""
    from ..serve import QuorumService
    B, S = args.batch, args.prefill
    # the cache splits into 4 chunks: round its length up to a multiple
    svc = QuorumService(pool, bundle, n_slots=B,
                        max_len=-(-(S + args.decode + 1) // 4) * 4)
    pf = bundle.make_batch("prefill", B, S,
                           torch.Generator(device=dev).manual_seed(1))
    prompts = [row.tolist() for row in pf["tokens"].cpu()]
    t0 = time.perf_counter()
    with torch.inference_mode():
        outs = svc.generate(prompts, max_new=args.decode)
    _sync(dev)
    wall = time.perf_counter() - t0
    rep = svc.report()
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
    given, receives the prefill and decode seconds and the decode tok/s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
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
    args = ap.parse_args(argv)
    if args.quorum and not args.ckpt_dir:
        raise SystemExit("--quorum serves the replicas of a checkpoint: "
                         "pass --ckpt-dir")

    dev = devmod.resolve(args.device)
    bundle = get_bundle(args.arch, reduced=args.reduced)
    if args.ckpt_dir:
        from ..serve import ReplicaPool, checkpoint_groups
        from ..serve.replica import tree_map
        step, R = checkpoint_groups(args.ckpt_dir)
        f = (R - 1) // 3   # the protocol's server tolerance for R groups
        pool = ReplicaPool.from_checkpoint(args.ckpt_dir, bundle.init,
                                           step=step, f=f, device=dev)
        print(f"[serve] restored step {step}: {R} replicas (f={f}) "
              f"from {args.ckpt_dir}")
        if args.quorum:
            return _serve_quorum(args, bundle, pool, dev)
        with torch.inference_mode():
            params = tree_map(lambda l: l.to(torch.bfloat16)
                              if l.dtype == torch.float32 else l,
                              pool.consolidated())
        del pool
        print("[serve] median-consolidated to one serving model")
    else:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = bundle.init(gen, dtype=torch.bfloat16)

    B, S = args.batch, args.prefill
    max_len = S + args.decode + 1
    caches = bundle.init_caches(B, max_len=max_len, n_chunks=1, device=dev)
    pf = bundle.make_batch("prefill", B, S,
                           torch.Generator(device=dev).manual_seed(1))

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, caches = bundle.prefill(params, pf, caches)
        _sync(dev)
        t_pf = time.perf_counter() - t0
        tok = torch.argmax(logits, -1)[:, None]
        out_tokens = [tok]
        t0 = time.perf_counter()
        for i in range(args.decode):
            logits, caches = bundle.decode(params, caches,
                                           decode_batch(bundle, pf, tok, i))
            tok = torch.argmax(logits, -1)[:, None]
            out_tokens.append(tok)
        _sync(dev)
        t_dec = time.perf_counter() - t0
    total = B * args.decode
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"[serve] {args.arch}: prefill {B}x{S} in {t_pf:.2f}s | "
          f"decode {args.decode} steps x batch {B} = {total} tokens in "
          f"{t_dec:.2f}s ({total / max(t_dec, 1e-9):.1f} tok/s on {where})")
    if stats is not None:
        stats.update(prefill_s=t_pf, decode_s=t_dec,
                     tok_s=total / max(t_dec, 1e-9))
    sample = torch.cat(out_tokens, dim=1)[0, :10]
    print(f"[serve] sample continuation ids: {sample.tolist()}")
    return torch.cat(out_tokens, dim=1)


if __name__ == "__main__":
    main()
