"""Step functions of the port (``steps``). The mesh and dry-run layer
comes with the distribution slice."""
