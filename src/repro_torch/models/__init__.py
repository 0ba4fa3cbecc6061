"""Model blocks of the port (counterpart of ``repro/models``): every
architecture of the reference's registry, served through
``serve.paged_lm`` or the dense-cache ``model.decode_step``, and trained
through ``train``."""
