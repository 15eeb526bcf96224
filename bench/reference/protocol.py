"""Plain reference of the ByzSGD protocol step on G co-located groups, in
float32 (TF32 off), from the benchmark's own inputs: the initial model,
each step's token batch and the replayed quorum tables.

One step at counter t, with learning rate eta_t = eta0 / (1 + decay t) in
float32:

  1. pull: worker g takes the coordinate-wise median of the server
     replicas its pull quorum delivers (the mean of the two middle values
     for an even count);
  2. gradients: worker g's gradient of its own batch's mean next-token
     loss at the pulled model, row by row;
  3. attack: the last ``n_byz`` workers send ALIE's vector, the honest
     rows' mean plus z times their per-coordinate deviation (ddof 0), z =
     Phi^-1((n - f - s) / (n - f)) with s = n // 2 + 1 - f;
  4. MDA: server s takes, of the gradients its push quorum delivers, the
     subset of q - f whose largest pairwise distance is least (the first
     in ``itertools.combinations`` order on a tie) and averages it. Given
     the program's picks, the reference follows them, as a served model's
     reference reads the served tokens, and judges each by its gap: how
     far the pick's diameter, in the reference's own distances, lies
     above the least (a near tie flips under rounding, and a trajectory
     that left the program's at a flip would compare two runs);
  5. update: replica s moves by -eta_t times that average;
  6. gather: when t + 1 is a multiple of T, every replica becomes the
     median of the replicas its gather quorum delivers.

Nothing here imports the program: the model is the family module of this
package that the configuration's ``model_type`` names, and every input is
the benchmark's.
"""
from __future__ import annotations

import importlib
import itertools
import math
from statistics import NormalDist

import numpy as np
import torch

COLS = 1 << 24          # columns of a [G, P] pass at a time


def family(c: dict):
    """The plain model of a configuration: the module of this package named
    by its ``model_type`` (``bench/reference/<model_type>.py``)."""
    return importlib.import_module(f"{__package__}.{c['model_type']}")


def spans(c: dict) -> list[tuple[str, tuple, int, int]]:
    """``(path, shape, offset, size)`` of each leaf in the flat layout: the
    leaves in path order, each flattened row-major."""
    out, off = [], 0
    for path, shape, _, _ in family(c).leaf_table(c):
        n = math.prod(shape)
        out.append((path, shape, off, n))
        off += n
    return out


def lr(t: int, eta0: float, decay: float) -> float:
    f = np.float32
    return float(f(eta0) / (f(1.0) + f(decay) * f(t)))


def alie_z(n: int, f: int) -> float:
    s = n // 2 + 1 - f
    frac = min(max((n - f - s) / (n - f), 1e-6), 1 - 1e-6)
    return NormalDist().inv_cdf(frac)


def median_rows(x: torch.Tensor) -> torch.Tensor:
    """``[q, c] -> [c]``: the mean of the two middle sorted values (the
    middle one for odd q). The rows are sorted by a bubble network of
    elementwise minima and maxima (``torch.sort`` past 8 rows)."""
    q = x.shape[0]
    if q > 8:
        rows = list(torch.sort(x, dim=0).values)
    else:
        rows = list(x)
        for end in range(q - 1, 0, -1):
            for i in range(end):
                rows[i], rows[i + 1] = (torch.minimum(rows[i], rows[i + 1]),
                                        torch.maximum(rows[i], rows[i + 1]))
    return 0.5 * (rows[(q - 1) // 2] + rows[q // 2])


def _median_into(params, idx, out):
    """Row r of ``out`` = the median of ``params``' rows ``idx[r]``, by
    column blocks (``out`` may be ``params``: a block is read whole
    first)."""
    for c0 in range(0, params.shape[1], COLS):
        blk = params[:, c0:c0 + COLS]
        res = torch.stack([median_rows(blk[[int(i) for i in row]])
                           for row in idx])
        out[:, c0:c0 + COLS] = res


def group_grad(c, pulled, tokens, labels, out) -> float:
    """Group gradient of the mean loss over ``tokens``' rows at the flat
    model ``pulled`` into ``out``; returns the loss."""
    sp = spans(c)
    leaves = [pulled[o:o + n].view(shape).detach().requires_grad_()
              for _, shape, o, n in sp]
    p = {path: leaf for (path, _, _, _), leaf in zip(sp, leaves)}
    loss = family(c).loss(p, tokens, labels, c)
    for (_, _, o, n), g in zip(sp, torch.autograd.grad(loss, leaves)):
        out[o:o + n] = g.reshape(-1)
    return float(loss.detach())


def sqdists(grads: torch.Tensor) -> np.ndarray:
    """Pairwise squared distances of ``grads``' rows ``[G, P]``, summed in
    float64 over column blocks."""
    G = grads.shape[0]
    d2 = torch.zeros((G, G), dtype=torch.float64, device=grads.device)
    for c0 in range(0, grads.shape[1], COLS):
        blk = grads[:, c0:c0 + COLS].double()
        for i, j in itertools.combinations(range(G), 2):
            d2[i, j] += torch.sum(torch.square(blk[i] - blk[j]))
    d2 = d2.cpu().numpy()
    return d2 + d2.T


def diameters(d2: np.ndarray, f: int) -> dict:
    """Each subset of q - f positions of the quorum (in
    ``itertools.combinations`` order) -> its largest pairwise squared
    distance."""
    q = d2.shape[0]
    return {sub: max((d2[i, j] for i, j in itertools.combinations(sub, 2)),
                     default=0.0)
            for sub in itertools.combinations(range(q), q - f)}


def leaf_norms(c, flat: torch.Tensor) -> np.ndarray:
    """Each leaf's L2 norm of a flat ``[P]`` vector."""
    return np.array([float(torch.linalg.vector_norm(flat[o:o + n]))
                     for _, _, o, n in spans(c)])


def run(c: dict, traffic: dict, p0: torch.Tensor, batches, tables,
        steps: int, picks=None) -> dict:
    """Follow ``steps`` protocol steps from the flat model ``p0`` (``[P]``
    float32) on ``batches`` (each ``{"tokens", "labels"}`` ``[G, B, S]``)
    and the quorum ``tables`` (``pull``, ``push``, ``gather``), with MDA's
    ``picks`` (``[step][server]`` sender lists) where given. Returns the
    readings the comparison takes: each step's loss of each group, each
    leaf's norm of each server's first aggregated gradient, each leaf's
    norm of each replica's change after the steps, and each step's largest
    relative gap of a pick's diameter over the least (inf for a pick that
    is not q - f delivered senders, or that is missing); besides, MDA's
    least margin between the best subset's diameter and the runner-up's,
    and the count of picks other than the reference's best."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    G, f_w = traffic["groups"], traffic["f_workers"]
    n_byz, T, t0 = traffic["n_byz_workers"], traffic["T"], traffic["t0"]
    P = p0.shape[0]
    params = p0[None].repeat(G, 1)
    grads = torch.empty_like(params)
    # one flat row of scratch: a worker's pulled model, then a server's
    # aggregated gradient
    row = torch.empty((1, P), dtype=torch.float32, device=p0.device)
    losses, margins, select_gaps, first = [], [], [], None
    other = 0
    z = alie_z(G, n_byz)
    for s in range(steps):
        t = t0 + s
        eta = lr(t, traffic["lr"], traffic["lr_decay"])
        b = batches[s]
        pull = tables["pull"][t % len(tables["pull"])]
        step_losses, have = [], None
        for g in range(G):
            delivered = sorted(int(i) for i in pull[g])
            if delivered != have:     # the same quorum pulls the same model
                _median_into(params, [delivered], row)
                have = delivered
            step_losses.append(group_grad(c, row[0], b["tokens"][g],
                                          b["labels"][g], grads[g]))
        losses.append(step_losses)
        if n_byz:
            h = G - n_byz
            for c0 in range(0, P, COLS):
                hon = grads[:h, c0:c0 + COLS]
                grads[h:, c0:c0 + COLS] = (
                    hon.mean(dim=0) + z * hon.std(dim=0, correction=0))
        push = tables["push"][t % len(tables["push"])]
        d2 = sqdists(grads)
        norms, gap = [], 0.0
        for srv in range(G):
            q = [int(i) for i in push[srv]]
            diam = diameters(d2[np.ix_(q, q)], f_w)
            best = min(diam, key=diam.get)      # the first of the least
            rest = sorted(v for k, v in diam.items() if k != best)
            least = max(diam[best], 1e-300)
            margins.append((rest[0] - diam[best]) / least if rest
                           else math.inf)
            chosen = [q[m] for m in best]
            if picks is not None:
                pos = tuple(sorted(q.index(i) for i in picks[s][srv]
                                   if i in q)) if s < len(picks) else ()
                if pos in diam and len(pos) == len(picks[s][srv]):
                    chosen = sorted(picks[s][srv])
                    gap = max(gap, (diam[pos] - diam[best]) / least)
                    other += pos != best
                else:
                    gap = math.inf
            for c0 in range(0, P, COLS):
                row[0, c0:c0 + COLS] = grads[chosen, c0:c0 + COLS].mean(dim=0)
            if s == 0:
                norms.append(leaf_norms(c, row[0]))
            params[srv] -= row[0].mul_(eta)
        select_gaps.append(gap)
        if s == 0:
            first = np.stack(norms)
        if (t + 1) % T == 0:
            r = (t + 1) // T - 1
            _median_into(params, tables["gather"][r % len(tables["gather"])],
                         params)
    change = np.stack([leaf_norms(c, params[g] - p0) for g in range(G)])
    return dict(losses=np.array(losses), first=first, change=change,
                select_gaps=select_gaps, mda_margin=float(min(margins)),
                other_picks=other)
