"""The repo's check scripts, on the port: the counterparts of the root
``scripts/check_*.py`` shims, each runnable as ``python -m
kubernetes_verification_tpu_torch.scripts.<name>``, over the port's own
gate, lint rules, baseline and metric registry."""
