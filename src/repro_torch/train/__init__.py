"""Training, the counterpart of ``repro.train``: AdamW with global-norm
clipping and its LR schedule (``optimizer``), the train and eval steps
with gradient accumulation (``steps``), and the ``Trainer`` loop over
the store's data loader, packed ingest and checkpoints (``trainer``)."""
