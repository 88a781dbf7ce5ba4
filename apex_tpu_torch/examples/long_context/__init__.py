"""Long-context GPT training with ring-attention context parallelism."""
