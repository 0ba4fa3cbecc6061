"""Training of the port's LMs (counterpart of ``repro/train``): AdamW,
error-feedback int8 gradient compression, and the train step, all on
``torch.autograd`` over the plain (``impl="ref"``) paths."""
