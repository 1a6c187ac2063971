"""Multi-device scaling over ``torch.distributed`` ranks: the ('tree', 'site')
mesh, sharded scoring, scans and training steps, the samplers' chain axis,
and joining a world (counterpart of ``trex_tpu/parallel``)."""

from trex_tpu_torch.parallel.chains import (
    chain_rows,
    gather_packed,
    gather_rows,
    psum_counts,
)
from trex_tpu_torch.parallel.distributed import initialize_distributed
from trex_tpu_torch.parallel.mesh import SITE_AXIS, TREE_AXIS, Mesh, is_output_rank, make_mesh
from trex_tpu_torch.parallel.sharded import (
    make_sharded_joint_step,
    make_sharded_restart_joint_step,
    sharded_batch_scores,
    sharded_best_tree,
    sharded_joint_step,
    sharded_log_likelihoods,
    sharded_per_site_matrix,
    sharded_spr_scan,
    sharded_spr_scan_best,
)

__all__ = [
    "make_mesh",
    "Mesh",
    "TREE_AXIS",
    "SITE_AXIS",
    "sharded_batch_scores",
    "sharded_best_tree",
    "sharded_joint_step",
    "sharded_log_likelihoods",
    "sharded_per_site_matrix",
    "sharded_spr_scan",
    "sharded_spr_scan_best",
    "make_sharded_joint_step",
    "make_sharded_restart_joint_step",
    "initialize_distributed",
    "chain_rows",
    "gather_rows",
    "gather_packed",
    "psum_counts",
    "is_output_rank",
]
