"""train layer of the port (see the package docstring): AdamW, the train
step and checkpoints into the object store."""
