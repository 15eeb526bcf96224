"""repro_torch.optim — the optimizer registry of ``repro.optim`` and the
learning-rate schedules.

``OPTIMIZERS`` is the registry ``ProtocolConfig.optimizer`` resolves: each
entry is an ``(init, update)`` pair with the uniform signature

    opt_state = init(params)
    new_params, new_opt_state = update(grads, opt_state, params, lr)

applied to the replica-stacked ``[G, P]`` flat parameter stack of the
protocol, so every server replica carries its own moment state. ``sgd`` is
stateless (the paper's Eq. 2 update) and the default everywhere.

The port updates in place to keep one copy of the replica stack on the
card: ``update`` overwrites ``params`` (and the moment buffers) and uses
``grads`` as scratch, then returns them; the values are the JAX update's.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from . import adamw, schedules, sgd  # noqa: F401


class Optimizer(NamedTuple):
    name: str
    init: Callable
    update: Callable


OPTIMIZERS: dict[str, Optimizer] = {
    "sgd": Optimizer("sgd", sgd.init, sgd.update),
    "adamw": Optimizer("adamw", adamw.init, adamw.update),
}


def get(name: str) -> Optimizer:
    try:
        return OPTIMIZERS[name]
    except KeyError:
        raise KeyError(f"unknown optimizer {name!r}; "
                       f"have {sorted(OPTIMIZERS)}") from None


__all__ = ["OPTIMIZERS", "Optimizer", "adamw", "get", "schedules", "sgd"]
