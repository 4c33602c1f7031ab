"""Device-mesh parallelism: batch DP, time-block halo SP, antenna axis,
plus multi-host launch scaffolding (jax.distributed across hosts)."""
from .distributed import (init_distributed, make_global_phy_mesh,
                          process_summary)
from .mesh import make_phy_mesh
from .sharded import (multichip_step, sharded_capture_decode,
                      sharded_frontend, sharded_rx)

__all__ = ["init_distributed", "make_global_phy_mesh", "make_phy_mesh",
           "multichip_step", "process_summary", "sharded_capture_decode",
           "sharded_frontend", "sharded_rx"]
