"""Actor/learner submeshes for decoupled SCST (the JAX package's
``parallel/submesh.py``).

``train.rl_topology="decoupled"`` (``rl/async_scst.py``) splits the ranks
of the 1-D data mesh into two disjoint sets: ACTOR ranks decode rollouts,
LEARNER ranks consume them with the REINFORCE update. A JAX device of the
split is a rank here (one process a device, ``train/mesh.py``), so a plan
holds ranks where the JAX plan holds devices: ``actor_ranks`` and
``learner_ranks`` (global ranks, actors first), and ``actor`` / ``learner``,
this rank's :class:`~cst_captioning_tpu_torch.train.mesh.DataMesh` of each
side (``train.mesh.submesh``: None on a rank outside it).

Two constraints shape the split, as in the JAX package:

- both sides need at least one rank (a 1-rank mesh gives the SHARED plan:
  one rank plays both roles, which is also the strict replay layout);
- each side's rank count must divide the global batch (its rows shard over
  the side), so counts clamp DOWN to the largest divisor of the batch
  size; the same rule reclamps the survivors after an ``actor_preempt``
  shrinks the actor side (:func:`shrink_actors`) and the grown set after a
  ``host_rejoin`` re-admits a shed rank (:func:`grow_actors`).

Building a plan creates the sides' process groups, which is collective
over the whole world: every rank plans, shrinks and grows in the same
order. A 2-D mesh (a ``(data, seq)`` or ``(data, mp)`` grid) is refused:
its row split comes with the model-parallel slice.
"""

from __future__ import annotations

from dataclasses import dataclass

from cst_captioning_tpu_torch.train.mesh import DataMesh, submesh

_MODEL_PARALLEL = "the model-parallel slice"


def largest_divisor(batch: int, upper: int) -> int:
    """Largest d with 1 <= d <= upper and batch % d == 0 (1 always works)."""
    upper = max(1, upper)
    if batch <= 0:
        return upper
    for d in range(min(upper, batch), 0, -1):
        if batch % d == 0:
            return d
    return 1


@dataclass(frozen=True)
class SubmeshPlan:
    """The actor/learner split of a data mesh, seen from this rank.

    ``shared`` marks the degenerate layout where both roles run on the
    whole mesh (1-rank meshes, and the strict replay mode). ``mesh`` is
    the mesh the plan cuts; shrinking and growing re-cut it.
    """

    actor: DataMesh | None
    learner: DataMesh | None
    actor_ranks: tuple
    learner_ranks: tuple
    shared: bool
    mesh: DataMesh | None = None

    @property
    def n_actors(self) -> int:
        return len(self.actor_ranks)

    @property
    def n_learners(self) -> int:
        return len(self.learner_ranks)


def _plan(mesh: DataMesh, actors, learners) -> SubmeshPlan:
    actors, learners = tuple(actors), tuple(learners)
    return SubmeshPlan(actor=submesh(mesh, actors),
                       learner=submesh(mesh, learners), actor_ranks=actors,
                       learner_ranks=learners, shared=False, mesh=mesh)


def shared_plan(mesh: DataMesh) -> SubmeshPlan:
    """Both roles on the full mesh (strict replay / 1-rank layout)."""
    ranks = mesh.global_ranks
    return SubmeshPlan(mesh, mesh, ranks, ranks, shared=True, mesh=mesh)


def plan_submesh(mesh: DataMesh, actor_fraction: float = 0.5,
                 batch_size: int = 0) -> SubmeshPlan:
    """Partition ``mesh`` into disjoint actor/learner submeshes.

    The actor side takes ``round(n * actor_fraction)`` ranks clamped so
    both sides keep at least one, then each side clamps down to the
    largest divisor of ``batch_size`` (0 = no batch constraint); actors
    are the first ranks. A mesh of one rank returns the shared plan. A
    2-D mesh raises: the row split of a grid comes with the
    model-parallel slice. The sides keep the mesh's axis name."""
    if len(mesh.axis_names) == 2:
        raise ValueError(
            f"plan_submesh got a 2-D {mesh.axis_names!r} mesh: the row split "
            f"of a grid is not ported yet ({_MODEL_PARALLEL})")
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"plan_submesh needs a 1-D or 2-D mesh, got axes "
            f"{mesh.axis_names!r}")
    ranks = mesh.global_ranks
    n = len(ranks)
    if n < 2:
        return shared_plan(mesh)
    n_actor = max(1, min(n - 1, round(n * actor_fraction)))
    n_actor = largest_divisor(batch_size, n_actor)
    n_learner = largest_divisor(batch_size, n - n_actor)
    return _plan(mesh, ranks[:n_actor], ranks[n_actor:n_actor + n_learner])


def shrink_actors(plan: SubmeshPlan, drop_index: int,
                  batch_size: int = 0) -> SubmeshPlan | None:
    """Remove one actor rank (an ``actor_preempt`` casualty) from the plan.

    ``drop_index`` indexes the CURRENT actor ranks modulo their count,
    mirroring how chaos faults address phantom hosts. Survivors reclamp to
    the largest batch divisor. Returns ``None`` when no actor survives:
    the caller falls back to the sync schedule on the learner submesh."""
    if plan.shared or plan.n_actors <= 1:
        return None
    survivors = list(plan.actor_ranks)
    del survivors[drop_index % len(survivors)]
    keep = largest_divisor(batch_size, len(survivors))
    return _plan(plan.mesh, survivors[:keep], plan.learner_ranks)


def grow_actors(plan: SubmeshPlan | None, rank: int, initial: SubmeshPlan,
                batch_size: int = 0, dead=()) -> SubmeshPlan | None:
    """Re-admit one actor rank (the inverse of :func:`shrink_actors`).

    ``initial`` is the pristine pre-fault plan: membership AND order come
    from it, so a shrink -> grow round trip restores the original rank
    order. ``dead`` names ranks still known lost; every other rank of the
    initial plan returns with the rejoiner (including ranks the shrink
    clamped away for batch divisibility: they were shed, not preempted).
    ``plan`` is the current (possibly shrunk) plan, or ``None`` when the
    caller fell back to the sync schedule with no live actor. The grown
    set reclamps to the largest batch divisor. Returns ``None`` when the
    membership would not change (shared initial plan, or a duplicate
    rejoin the clamp swallows); raises if ``rank`` was never part of the
    initial plan."""
    if initial.shared:
        return None
    if rank not in initial.actor_ranks:
        raise ValueError(
            f"grow_actors rank {rank} was never in the initial actor plan "
            f"({initial.actor_ranks})")
    current = set() if plan is None or plan.shared else set(plan.actor_ranks)
    gone = set(dead) - {rank}
    members = tuple(r for r in initial.actor_ranks if r not in gone)
    members = members[:largest_divisor(batch_size, len(members))]
    if set(members) == current:
        return None
    return _plan(initial.mesh, members, initial.learner_ranks)
