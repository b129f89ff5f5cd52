"""The launch layer of the port: step functions (``steps``), meshes and
process groups (``mesh``), the fake-mesh dry run (``dryrun``) with its
per-device op counter (``op_analysis``) and roofline report
(``roofline``)."""
