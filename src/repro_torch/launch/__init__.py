"""Launch tooling of the port (counterpart of ``repro/launch``): the
distributed serving plans (:mod:`repro_torch.launch.serve`) and the
``--arch`` training launcher (:mod:`repro_torch.launch.train`)."""
