"""Elastic fleet membership — the port of ``repro.core.membership``.

Membership is a declarative plan over virtual steps, and the elastic runner
(``runner="elastic"``) chunks the protocol run at every membership boundary:

* :class:`MembershipPlan` — a sorted tuple of :class:`MembershipEvent`
  (``leave``/``join`` of a group id at a virtual step), authored directly or
  lowered from a realized ``netsim`` crash trace (:func:`plan_from_trace`:
  a crash and its recovery are a leave, then a join, of the same group).
* :meth:`MembershipPlan.epochs` — segments ``[0, steps)`` into
  :class:`MembershipEpoch` windows with one active-group set each.
* :func:`epoch_config` — the resilience parameters of the shrunk (or
  regrown) fleet, re-validated against the paper's Table 1
  (``n_ps >= 3f_ps+2``, ``n_w >= 3f_w+1``) at every transition; shrinking
  below the floor of the Byzantine nodes actually present raises
  :class:`MembershipFloorError`.
* :func:`reform_params` — maps the flat ``[G, P]`` replica stack from one
  active set to the next. A re-admitted group is seeded from the
  coordinate-wise median of the survivors (the DMC rule, the median kernel
  on the card), so the joiner lands inside the honest replicas' diameter.
* :func:`reform_state` — the same for a run's whole state, from one
  segment's rank mesh to the next (``launch.mesh.make_segment_mesh``): the
  stacks gathered whole, handed to the ranks that join the mesh,
  re-stacked and cut into the new blocks; its bytes a rank sends are
  :func:`reform_volume_bytes`.

The effective per-epoch resilience is ``f' = min(declared f, structural max
for G')`` with full-minus-f quorums, so a fleet that regrows returns to the
declared configuration, and an empty plan is ``runner="protocol"`` bit for
bit.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import agg
from .quorum import validate_counts


class MembershipFloorError(ValueError):
    """A membership transition would violate the Table-1 resilience floor
    (or leave no survivor to seed from)."""


@dataclass(frozen=True)
class MembershipEvent:
    """One membership change at a virtual-step boundary: ``group`` leaves or
    (re-)joins *before* step ``step`` executes."""
    step: int
    kind: str          # "leave" | "join"
    group: int

    def __post_init__(self):
        if self.kind not in ("leave", "join"):
            raise ValueError(f"unknown membership event kind {self.kind!r}; "
                             "choose 'leave' or 'join'")
        if self.step < 1:
            raise ValueError(f"membership events happen at step boundaries "
                             f">= 1, got step={self.step}")
        if self.group < 0:
            raise ValueError(f"group must be >= 0, got {self.group}")


@dataclass(frozen=True)
class MembershipEpoch:
    """A maximal step window with a constant active-group set."""
    start: int
    stop: int
    active: tuple[int, ...]   # sorted group ids


@dataclass(frozen=True)
class MembershipPlan:
    """A declarative join/leave schedule in virtual steps (empty = static
    fleet). Events are normalized to (step, kind, group) order, so two
    plans with the same events are equal and hash alike."""
    events: tuple[MembershipEvent, ...] = ()

    def __post_init__(self):
        evs = []
        for ev in self.events:
            if isinstance(ev, dict):
                ev = MembershipEvent(step=int(ev["step"]),
                                     kind=str(ev["kind"]),
                                     group=int(ev["group"]))
            if not isinstance(ev, MembershipEvent):
                raise TypeError("MembershipPlan events must be "
                                f"MembershipEvent, got {type(ev).__name__}")
            evs.append(ev)
        evs.sort(key=lambda e: (e.step, e.kind, e.group))
        object.__setattr__(self, "events", tuple(evs))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MembershipPlan":
        return cls(events=tuple(d.get("events", ())))

    def epochs(self, n_groups: int,
               steps: int) -> tuple[MembershipEpoch, ...]:
        """Segment ``[0, steps)`` into constant-membership windows, starting
        from ``active = {0..n_groups-1}``. Events must land inside the run,
        a group must be active to leave and inactive to join (a join beyond
        the launch G enlists a new group id)."""
        by_step: dict[int, list[MembershipEvent]] = {}
        for ev in self.events:
            if ev.step >= steps:
                raise ValueError(
                    f"membership event at step {ev.step} is outside the run "
                    f"(steps={steps})")
            by_step.setdefault(ev.step, []).append(ev)
        active = set(range(n_groups))
        out = []
        start = 0
        for step in sorted(by_step):
            if step > start:
                out.append(MembershipEpoch(start, step,
                                           tuple(sorted(active))))
                start = step
            for ev in by_step[step]:
                if ev.kind == "leave":
                    if ev.group not in active:
                        raise ValueError(f"group {ev.group} leaves at step "
                                         f"{ev.step} but is not active")
                    active.remove(ev.group)
                else:
                    if ev.group in active:
                        raise ValueError(f"group {ev.group} joins at step "
                                         f"{ev.step} but is already active")
                    active.add(ev.group)
        out.append(MembershipEpoch(start, steps, tuple(sorted(active))))
        return tuple(out)


def epoch_config(pcfg0, active: tuple[int, ...], *,
                 synchronous: bool = False):
    """The :class:`~repro_torch.core.protocol.ProtocolConfig` of one
    membership epoch: ``pcfg0`` itself at the launch size; otherwise
    ``f' = min(declared f, structural max for G')`` with full-minus-f
    quorums, re-validated against Table 1. Shrinking below the floor of
    the declared-present Byzantine counts raises
    :class:`MembershipFloorError`."""
    Gp = len(active)
    if Gp == pcfg0.n_groups:
        return pcfg0
    if Gp < 2:
        raise MembershipFloorError(
            f"membership shrank to {Gp} group(s) (active={active}); the "
            "protocol needs >= 2 groups to form any quorum")
    # the quorum window 2f_w+1 <= q_w <= G'-f_w caps f_w at (G'-1)//3 in
    # both variants (sync's cheaper n_w >= 2f_w+1 bound never binds first)
    f_w_max = (Gp - 1) // 3
    f_ps_max = max((Gp - 2) // 3, 0)
    f_w = min(pcfg0.f_workers, f_w_max)
    f_ps = min(pcfg0.f_servers, f_ps_max)
    byz = pcfg0.byz
    if byz.n_byz_workers > f_w or byz.n_byz_servers > f_ps:
        raise MembershipFloorError(
            f"shrinking to G'={Gp} caps the tolerable faults at "
            f"f_w'={f_w}, f_ps'={f_ps}, below the declared-present Byzantine "
            f"counts ({byz.n_byz_workers} workers, {byz.n_byz_servers} "
            "servers) — the surviving fleet cannot outvote the adversary "
            "(Table 1: n_w >= 3f_w+1, n_ps >= 3f_ps+2)")
    q_w = Gp - f_w
    q_ps = max(Gp - f_ps, min(2 * f_ps + 2, Gp))
    try:
        validate_counts(Gp, f_w, Gp, f_ps, q_w, q_ps,
                        synchronous=synchronous)
    except ValueError as err:
        raise MembershipFloorError(
            f"membership transition to active={active} (G'={Gp}) violates "
            f"the resilience preconditions: {err}") from err
    return dataclasses.replace(pcfg0, n_groups=Gp, f_workers=f_w,
                               f_servers=f_ps, q_workers=q_w, q_servers=q_ps)


def reform_params(params: torch.Tensor, old_active: tuple[int, ...],
                  new_active: tuple[int, ...],
                  chunk_bytes: int = 256 * 2**20) -> torch.Tensor:
    """Re-stack the ``[G, P]`` replicas from one active set to the next: a
    new ``[G', P]`` stack in the input's dtype. Survivor rows are carried
    over; a joining group's row is the coordinate-wise median of the
    survivors in float32 (the median kernel on the card), streamed by
    column chunks of at most ``chunk_bytes``."""
    idx = {g: i for i, g in enumerate(old_active)}
    survivors = [g for g in new_active if g in idx]
    if not survivors:
        raise MembershipFloorError(
            f"no surviving group between active sets {old_active} -> "
            f"{new_active}; nothing to seed the new fleet from")
    src = torch.as_tensor([idx.get(g, 0) for g in new_active],
                          device=params.device)
    out = params.index_select(0, src)
    joiners = [i for i, g in enumerate(new_active) if g not in idx]
    if joiners:
        take = torch.as_tensor([idx[g] for g in survivors],
                               device=params.device)
        P = params.shape[1]
        c = max(1, chunk_bytes // (4 * len(survivors)))
        for c0 in range(0, P, c):
            med = agg.dispatch.cwise_median(
                params[:, c0:c0 + c].index_select(0, take).float())
            out[joiners, c0:c0 + c] = med.to(out.dtype)
    return out


def reform_state(state, old_active: tuple[int, ...],
                 new_active: tuple[int, ...], mesh=None,
                 chunk_bytes: int = 256 * 2**20):
    """The run's ``ByzState`` for the next membership segment, on ``mesh``
    (that segment's): params and AdamW's moments re-stacked by
    :func:`reform_params`. Over ranks every rank of the world calls it:

    1. the old mesh's ranks gather each stack whole;
    2. rank 0 hands the stacks, the step counter, AdamW's count and the
       generator's state to the ranks of the new mesh that sat the old one
       out (``Mesh.share``);
    3. each rank of the new mesh runs :func:`reform_params` on the whole
       stacks: no summation, so the same stack on every rank, bit for bit;
    4. each keeps its block of the new mesh (``protocol.shard_state``).

    Every collective is counted under the tag ``reform``
    (:func:`reform_volume_bytes`). A rank that sits the new mesh out keeps
    the empty ``[G', 0]`` stacks; one that sat the old mesh out too also
    keeps its (stale) counters until it joins. On one rank this is
    :func:`reform_params` on each stack."""
    from .protocol import shard_state, whole_state
    upto = mesh.n_ranks if mesh is not None else 1
    state = whole_state(state, tag="reform", upto=upto)
    opt = state.opt
    if mesh is not None and not mesh.member:
        def empty(x):
            return x.new_empty((len(new_active), 0))
        if opt:
            opt = type(opt)(empty(opt.m), empty(opt.v), opt.count)
        return state._replace(params=empty(state.params), opt=opt,
                              mesh=mesh, split=None)

    def re(x):
        return reform_params(x, old_active, new_active, chunk_bytes)

    if opt:
        opt = type(opt)(re(opt.m), re(opt.v), opt.count)
    return shard_state(state._replace(params=re(state.params), opt=opt),
                       mesh)


def reform_volume_bytes(old_shape, new_shape, n_groups: int, n_params: int,
                        itemsize: int, *, rank: int, stacks: int = 1,
                        run_state_bytes: int = 0) -> int:
    """The bytes rank ``rank`` sends at a membership boundary
    (:func:`reform_state`, tag ``reform``), from a ``(rep, K, 1)`` mesh of
    ``old_shape`` holding ``stacks`` ``[G, P]`` stacks of ``itemsize``
    bytes (the params; AdamW's two float32 moments make 3) to a mesh of
    ``new_shape``, both on the world's first ranks:

    * each rank of the old mesh gathers every stack whole: over 'rep',
      ``(rep-1)·(G/rep)·P_k`` entries, ``P_k`` the column count of its
      'fsdp' coordinate; then over 'fsdp', ``(K-1)·G·ceil(P/K)`` (the
      blocks padded to the widest);
    * rank 0 sends to each rank of the new mesh past the old mesh's end
      every stack whole, ``G·P`` entries, and the run's state,
      ``run_state_bytes`` (the generator's state and two int64
      counters).

    Of the new mesh only its rank count enters, and G' not at all: a rank
    cuts its new block from the whole re-formed stack, which moves
    nothing."""
    rep, K, M = (int(n) for n in old_shape)
    if M != 1:
        raise ValueError(f"the elastic runner's meshes have no 'model' "
                         f"axis; got {tuple(old_shape)}")
    G, P = int(n_groups), int(n_params)
    old_ranks, new_ranks = rep * K, int(np.prod(new_shape))
    out = 0
    if rank < old_ranks:
        k = rank % K
        cols = (k + 1) * P // K - k * P // K
        out += stacks * itemsize * ((rep - 1) * (G // rep) * cols
                                    + (K - 1) * G * -(-P // K))
    if rank == 0:
        out += max(new_ranks - old_ranks, 0) * (stacks * G * P * itemsize
                                                + run_state_bytes)
    return out


def plan_from_trace(scenario, trace) -> MembershipPlan:
    """Lower a realized netsim run into a :class:`MembershipPlan`.

    A protocol group is down while its server node (id g) — or, for the
    co-located shape (n_workers == n_servers), its worker node
    (id n_servers + g) — sits inside a ``CrashPlan`` window. The *leave*
    step maps through the trace's realized step-completion times (the group
    leaves before the first step finishing after ``t_down``). The *join*
    step maps the outage duration through the honest pre-crash step rate:
    after ``t_up`` a recovered laggard replays its backlog almost at once,
    and the wall-clock mapping would compress any outage to one step, while
    the survivors keep stepping at the honest rate, and their step clock is
    what membership is measured in. Windows that resolve before step 1 or
    open after the run are dropped; a crash whose recovery maps past the
    run is a leave without a join."""
    done = np.maximum.accumulate(np.asarray(trace.step_done_ms, np.float64))
    steps = len(done)
    t_first = min((w.t_down for w in scenario.faults.crashes.windows),
                  default=np.inf)
    k_first = int(np.searchsorted(done, t_first, side="left"))
    diffs = np.diff(done[:k_first]) if k_first >= 2 else np.diff(done)
    rate = max(float(np.median(diffs)) if diffs.size else 1.0, 1e-9)
    colocated = scenario.n_workers == scenario.n_servers
    events = []
    for g in range(scenario.n_servers):
        nodes = {g} | ({scenario.n_servers + g} if colocated else set())
        iv = sorted((w.t_down, w.t_up)
                    for w in scenario.faults.crashes.windows
                    if w.node in nodes)
        merged: list[list[float]] = []
        for lo, hi in iv:
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        for lo, hi in merged:
            leave = max(int(np.searchsorted(done, lo, side="left")), 1)
            if leave >= steps:
                continue
            join = (leave + max(int(round((hi - lo) / rate)), 1)
                    if np.isfinite(hi) else steps)
            events.append(MembershipEvent(step=leave, kind="leave", group=g))
            if join < steps:
                events.append(MembershipEvent(step=join, kind="join",
                                              group=g))
    return MembershipPlan(events=tuple(events))
