"""Parallelism across devices (the JAX package's ``parallel/``): the
gradient communication of the data-parallel steps (``comms.py``). The
actor/learner submeshes, the compile layer and sequence parallelism come
with their slices (ROADMAP.md)."""

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

__all__ = [
    "Bucket",
    "BucketPlan",
    "CommConfig",
    "GradReducer",
    "Reduction",
    "ledger",
    "mp_shard_view",
    "per_leaf_f32_bytes",
    "plan_buckets",
    "reduce_sums",
    "reduce_tree",
    "start_reduce",
]
