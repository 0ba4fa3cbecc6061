"""Model blocks of the port (counterpart of ``repro/models``): the dense
GQA decoder path that ``serve.paged_lm`` runs."""
