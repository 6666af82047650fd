"""Entry points of the port (``python -m cpd_tpu_torch.examples...``)."""
