"""Examples of the port, runnable as modules (``python -m
apex_tpu_torch.examples.imagenet.main_amp``)."""
