"""Launchers (``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.train``, ``python -m repro_torch.launch.dryrun``), the step
builders they use (``steps``) and the dry run's meta-tensor inputs
(``input_specs``)."""
