"""Sequential slab reclamation of a delete batch (a CUDA kernel with no
TPU counterpart: it replaces a ``fori_loop`` of the reference delete)."""
