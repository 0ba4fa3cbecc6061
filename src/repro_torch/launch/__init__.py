"""Launchers of the port (counterpart of ``repro/launch``): the trainer
(``launch.train``), the model mesh and its specs (``launch.mesh``,
``launch.specs``), and the dry run of every production cell on the
``meta`` device (``launch.dryrun``, counted by ``launch.op_count``,
bounded by ``launch.roofline``)."""
