"""Training substrate of the port (mirrors ``repro/train/``): optimizers,
the train step, checkpointing, the fault-tolerant loop and the synthetic
data pipeline."""
