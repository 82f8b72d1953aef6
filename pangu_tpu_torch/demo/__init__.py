"""The forecast demo of the port (``python -m pangu_tpu_torch.demo.app``)."""
