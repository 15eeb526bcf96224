"""Logical sharding rules and the tensor-parallel ('model' axis) operations
— the port of ``repro.models.sharding``.

The reference annotates activations with logical names (``act_btd``,
``act_heads``, ``act_kv_heads``, ``logits``, ``kv_cache``) through
``shard(x, name)`` hooks and GSPMD turns a rule table into collectives.
The port has no hooks: it computes tensor parallelism explicitly. The
launch layer installs a :class:`Rules` table with
:func:`sharding_rules`, and the model functions read, for each logical
name, which dim a rank holds on 'model' (and on 'data' / 'fsdp'), and run
the column- and row-parallel forms of their products through the four
operations below, over the table's 'model' process group (the mesh's
line of ranks along 'model' through this rank). Outside a rule context,
or with a 'model' axis of one rank, :func:`active` is ``None`` and every
model function runs its single-card code unchanged.

The operations follow Megatron-LM's conjugate pairs, with every reduction
an all-gather then a sum in rank order (a float32 sum cast back), so each
rank holds the same bits:

  * :func:`copy_to_model` — identity forward, sum of the ranks' gradients
    backward (a replicated input feeding a column-parallel product);
  * :func:`reduce_from_model` — sum of the ranks' partials forward,
    identity backward (a row-parallel product's output);
  * :func:`scatter_to_model` — this rank's block of a dim forward, the
    blocks' gradients gathered backward (a replicated input feeding a
    row-parallel product);
  * :func:`gather_from_model` — the blocks gathered forward, this rank's
    block of the gradient backward (a split leaf used whole).

Each counts the bytes this rank sends on the mesh under its tag
(``Mesh.sent``): ``model`` for activations, ``model_leaves`` for leaves
gathered whole, ``model_loss`` for the loss's statistics (the
vocab-parallel loss's, the paper's MLP's L2 sum).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch


class Rules:
    """A rule table: ``table[name] = {"model": dim, "data": dim}`` (a
    missing axis, or ``None``, keeps that dim whole on the rank), and the
    mesh whose 'model' axis the table's collectives run over."""

    def __init__(self, table: dict, mesh=None):
        self.table = {k: dict(v) for k, v in table.items()}
        self.mesh = mesh
        self.M = mesh.size("model") if mesh is not None else 1
        self.m = mesh.coord("model") if self.M > 1 else 0

    def __repr__(self):
        return f"Rules(M={self.M}, m={self.m}, {sorted(self.table)})"

    def dim(self, name: str, axis: str = "model"):
        """The dim of ``name`` a rank holds a block of on ``axis``, or
        ``None`` (whole)."""
        return self.table.get(name, {}).get(axis)

    def split(self, name: str) -> bool:
        """True when ``name`` is split over 'model' (on more than one
        rank)."""
        return self.M > 1 and self.dim(name) is not None

    def block(self, n: int) -> tuple[int, int]:
        """This rank's range of ``n`` entries split over 'model'."""
        b = n // self.M
        return self.m * b, (self.m + 1) * b


_RULES: Rules | None = None


@contextmanager
def sharding_rules(rules: Rules | None):
    """Install ``rules`` for the model functions called inside."""
    global _RULES
    old = _RULES
    _RULES = rules
    try:
        yield rules
    finally:
        _RULES = old


def active() -> Rules | None:
    """The installed table when it splits over 'model' (M > 1), else
    ``None``: the model functions take their single-card path."""
    return _RULES if _RULES is not None and _RULES.M > 1 else None


# ---------------------------------------------------------------------------
# collectives over 'model'
# ---------------------------------------------------------------------------

def gather_ranks(mesh, x: torch.Tensor, tag: str) -> torch.Tensor:
    """``[M, *x.shape]``: every 'model' rank's ``x``, in rank order."""
    return mesh.all_gather(x.contiguous()[None], "model", tag)


def sum_ranks(mesh, x: torch.Tensor, tag: str) -> torch.Tensor:
    """The sum of every 'model' rank's ``x`` in rank order, added in
    float32 and cast back to ``x``'s dtype (the same bits on every
    rank)."""
    parts = gather_ranks(mesh, x, tag)
    out = parts[0].float()
    for j in range(1, parts.shape[0]):
        out += parts[j]
    return out.to(x.dtype)


def cat_ranks(mesh, x: torch.Tensor, dim: int, tag: str) -> torch.Tensor:
    """Every 'model' rank's block of ``dim`` joined in rank order."""
    parts = gather_ranks(mesh, x, tag)
    return torch.cat(list(parts.unbind(0)), dim=dim)


def _narrow(x: torch.Tensor, dim: int, M: int, m: int) -> torch.Tensor:
    n = x.shape[dim] // M
    return x.narrow(dim, m * n, n)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules, tag):
        ctx.rules, ctx.tag = rules, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_ranks(ctx.rules.mesh, g, ctx.tag), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules, tag):
        return sum_ranks(rules.mesh, x, tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules, dim, tag):
        ctx.rules, ctx.dim, ctx.tag = rules, dim, tag
        return _narrow(x, dim, rules.M, rules.m)

    @staticmethod
    def backward(ctx, g):
        return cat_ranks(ctx.rules.mesh, g, ctx.dim, ctx.tag), None, None, \
            None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules, dim, tag):
        ctx.rules, ctx.dim = rules, dim
        return cat_ranks(rules.mesh, x, dim, tag)

    @staticmethod
    def backward(ctx, g):
        return (_narrow(g, ctx.dim, ctx.rules.M, ctx.rules.m), None, None,
                None)


def copy_to_model(x, rules: Rules, tag: str = "model"):
    return _Copy.apply(x, rules, tag)


def reduce_from_model(x, rules: Rules, tag: str = "model"):
    return _Reduce.apply(x, rules, tag)


def scatter_to_model(x, rules: Rules, dim: int = -1, tag: str = "model"):
    return _Scatter.apply(x, rules, dim % x.ndim, tag)


def gather_from_model(x, rules: Rules, dim: int = -1, tag: str = "model"):
    return _Gather.apply(x, rules, dim % x.ndim, tag)
