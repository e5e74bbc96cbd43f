"""Parallelism across devices (the JAX package's ``parallel/``): the
gradient communication of the data-parallel steps (``comms.py``), the
actor/learner submeshes of decoupled SCST (``submesh.py``) and frame-axis
sequence parallelism over a ``('data', 'seq')`` grid of ranks
(``seq_parallel.py``). The JAX compile layer has no counterpart: the port
has no compile step to choose among (ROADMAP.md)."""

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
from cst_captioning_tpu_torch.parallel.seq_parallel import (
    make_sp_decode,
    make_sp_forward,
    make_sp_rl_update,
    make_sp_xe_step,
    seq_enter,
    seq_max,
    seq_sum,
    sp_batch_shardings,
    sp_batch_specs,
    sp_model,
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
    "make_sp_decode",
    "make_sp_forward",
    "make_sp_rl_update",
    "make_sp_xe_step",
    "mp_shard_view",
    "per_leaf_f32_bytes",
    "plan_buckets",
    "plan_submesh",
    "reduce_sums",
    "reduce_tree",
    "seq_enter",
    "seq_max",
    "seq_sum",
    "shared_plan",
    "shrink_actors",
    "sp_batch_shardings",
    "sp_batch_specs",
    "sp_model",
    "start_reduce",
]
