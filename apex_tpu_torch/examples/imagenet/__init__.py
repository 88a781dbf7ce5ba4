"""ResNet-50 ImageNet training with amp, SyncBatchNorm and DDP."""
