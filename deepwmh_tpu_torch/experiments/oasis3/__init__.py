"""The OASIS-3 replication recipe (PARITY C13) on the port:
``python -m deepwmh_tpu_torch.experiments.oasis3.run_oasis3``."""
