"""Launchers of the port: the step functions, the training and serving
CLIs, the production meshes and the dry run."""
