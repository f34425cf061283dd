"""Measurement entry points of the port (``python -m multitreegp_tpu_torch.tools.<name>``)."""
