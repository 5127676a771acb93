"""Training: AdamW, checkpoints and the loop (port of ``repro.train``)."""
