"""Launch tooling of the port (counterpart of ``repro/launch``): the
distributed serving plans (:mod:`repro_torch.launch.serve`), the
``--arch`` training launcher (:mod:`repro_torch.launch.train`) and the dry
run (:mod:`repro_torch.launch.dryrun`: the cell builders of
:mod:`~repro_torch.launch.steps` on the logical meshes of
:mod:`~repro_torch.launch.mesh`, counted by
:mod:`~repro_torch.launch.op_stats` and bounded by
:mod:`~repro_torch.launch.analysis`)."""
