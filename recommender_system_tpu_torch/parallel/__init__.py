"""Tables sharded by row (and by column on a model axis) and MMOE's experts
over a ``torch.distributed`` process group (counterpart of
``recommender_system_tpu/parallel``)."""
from .embedding import (alltoall_lookup, gspmd_lookup, mod_shard_table, sharded_lookup,
                        unshard_table)
from .fused import alltoall_take, column_take, sharded_fused_update
from .launch import host_batch_slice, initialize, make_pod_mesh
from .mesh import Mesh, Placement, make_mesh, param_shardings, shard_table, table_sharding
