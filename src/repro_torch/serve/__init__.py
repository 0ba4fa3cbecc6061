"""Serving of the port (counterpart of ``repro/serve``): the slab-paged KV
cache and the batched LM engine over it."""
