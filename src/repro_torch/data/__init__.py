"""Data of the port: the numpy synthetic task."""
