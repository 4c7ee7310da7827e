"""Entry points of the port: ``python -m dvbt2ll_tpu_torch.apps.<name>``."""
