"""Training: the data pipeline, the optimizers, the train step and the
checkpoints (the reference's ``repro/train``)."""
