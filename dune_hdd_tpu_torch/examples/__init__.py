"""Example workflows of the port, run as modules
(``python -m dune_hdd_tpu_torch.examples.<name>``)."""
