"""Parallelism across devices (the JAX package's ``parallel/``): the
gradient communication of the data-parallel steps (``comms.py``) and the
actor/learner submeshes of decoupled SCST (``submesh.py``). The compile
layer and sequence parallelism come with their slice (ROADMAP.md)."""

from cst_captioning_tpu_torch.parallel.comms import (
    Bucket,
    BucketPlan,
    CommConfig,
    GradReducer,
    Reduction,
    ledger,
    mp_shard_view,
    per_leaf_f32_bytes,
    plan_buckets,
    reduce_sums,
    reduce_tree,
    start_reduce,
)
from cst_captioning_tpu_torch.parallel.submesh import (
    SubmeshPlan,
    grow_actors,
    largest_divisor,
    plan_submesh,
    shared_plan,
    shrink_actors,
)

__all__ = [
    "Bucket",
    "BucketPlan",
    "CommConfig",
    "GradReducer",
    "Reduction",
    "SubmeshPlan",
    "grow_actors",
    "largest_divisor",
    "ledger",
    "mp_shard_view",
    "per_leaf_f32_bytes",
    "plan_buckets",
    "plan_submesh",
    "reduce_sums",
    "reduce_tree",
    "shared_plan",
    "shrink_actors",
    "start_reduce",
]
