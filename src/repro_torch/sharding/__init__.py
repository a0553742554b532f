"""Partitioning rules of the port (counterpart of ``repro/sharding``): the
LM rules (:mod:`repro_torch.sharding.rules`) and the recommenders'
(:mod:`repro_torch.sharding.recsys_rules`), over the logical meshes of
``repro_torch.launch.mesh``."""
