"""Cross-slab data movement of the port: the streamed swap's shuffle
planner (:mod:`bolt_tpu_torch.parallel.shuffle`)."""
