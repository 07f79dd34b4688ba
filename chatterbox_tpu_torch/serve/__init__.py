"""The HTTP serving layer of the port: ``python -m chatterbox_tpu_torch.serve``."""
