"""Serving of the port (counterpart of ``repro/serve``): the streaming
SIVF serve engine (``sivf_engine``, with ``quota`` and ``session``), and
the slab-paged KV cache and the batched LM engine over it."""
