"""The DCGAN multi-loss amp example."""
