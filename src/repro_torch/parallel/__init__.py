"""Distribution of the port over ``torch.distributed``: the reference's
sharding rules (``sharding.py``), activation layouts (``constrain.py``),
the per-module shards and their forwards (``tensor.py``) and the counted
collectives (``comm.py``).  Meshes: ``repro_torch.launch.mesh``."""
from .comm import (COLLECTIVES, MeshAxis, broadcast, gather_cat,
                   gather_on_use, gather_sum, reduce_scatter_ordered,
                   reset_collectives)
from .constrain import activation_mesh, current_mesh, shard
from .sharding import (Placement, batch_specs, cache_specs, dp_axes,
                       dp_size, mesh_axes, page_pool_specs, param_spec,
                       port_spec, reference_path, shard_module)

__all__ = ["COLLECTIVES", "MeshAxis", "broadcast", "gather_cat",
           "gather_on_use", "gather_sum", "reduce_scatter_ordered",
           "reset_collectives", "activation_mesh",
           "current_mesh", "shard", "Placement", "batch_specs",
           "cache_specs", "dp_axes", "dp_size", "mesh_axes",
           "page_pool_specs", "param_spec", "port_spec", "reference_path",
           "shard_module"]
