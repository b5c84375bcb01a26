"""Multi-device layer: logical-axis rules and their placements on a torch
device mesh (:mod:`repro_torch.distributed.sharding`)."""
