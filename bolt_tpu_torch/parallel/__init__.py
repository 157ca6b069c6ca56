"""The port's device meshes and cross-rank data movement.

* :mod:`~bolt_tpu_torch.parallel.mesh` — meshes of ranks, one process and
  one ``torch.device`` a rank;
* :mod:`~bolt_tpu_torch.parallel.sharding` — the key/value sharding
  specs, each rank's box, and the one-``all_to_all`` relayout;
* :mod:`~bolt_tpu_torch.parallel.halo` — neighbour halo exchange;
* :mod:`~bolt_tpu_torch.parallel.multihost` — the ``torch.distributed``
  bootstrap, topology and collectives (its one home, lint rule BLT110);
* :mod:`~bolt_tpu_torch.parallel.harness` — local pods of worker
  processes (``python -m bolt_tpu_torch.parallel.harness``);
* :mod:`~bolt_tpu_torch.parallel.shuffle` — the streamed swap's shuffle
  planner.
"""

from bolt_tpu_torch.parallel import multihost
from bolt_tpu_torch.parallel.halo import exchange_halo
from bolt_tpu_torch.parallel.mesh import (default_mesh, ensure_auto,
                                          initialize_distributed, layout,
                                          make_mesh)
from bolt_tpu_torch.parallel.sharding import (combined_spec, key_sharding,
                                              key_spec, reshard, spec_names)

__all__ = ["default_mesh", "ensure_auto", "make_mesh", "multihost",
           "initialize_distributed", "combined_spec", "key_spec",
           "spec_names", "key_sharding", "reshard", "exchange_halo",
           "layout"]
