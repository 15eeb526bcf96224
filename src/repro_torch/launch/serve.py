"""Batched serving driver (port of ``repro.launch.serve``'s default path):
random init from a seed, cast to bf16 for single-model serving, one prefill
of a random batch, then greedy decode.

  python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --batch 4 --prefill 64 --decode 32

Runs on the GPU; ``--device cpu`` (with ``--reduced``) is for smoke runs.
Restoring a ByzSGD checkpoint (``--ckpt-dir``, ``--quorum``) waits for the
checkpointer port; the TPU mesh (``--mesh``) has no counterpart on one card.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import device as devmod
from ..models.registry import get_bundle


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prefill", type=int, default=64)
    ap.add_argument("--decode", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--quorum", action="store_true")
    args = ap.parse_args(argv)
    if args.ckpt_dir or args.quorum:
        raise SystemExit("--ckpt-dir/--quorum need the checkpointer port "
                         "(ROADMAP.md, queue 1)")

    dev = devmod.resolve(args.device)
    bundle = get_bundle(args.arch, reduced=args.reduced)
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
        for _ in range(args.decode):
            logits, caches = bundle.decode(params, caches, {"token": tok})
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
    sample = torch.cat(out_tokens, dim=1)[0, :10]
    print(f"[serve] sample continuation ids: {sample.tolist()}")


if __name__ == "__main__":
    main()
